"""Launch geometry of the plane-sweep kernels K1/K5
(``keff_structured_halo``), K2 (``pc_keff_structured``) and K6
(``pcg_iteration_structured``), and the taps they take by value.

A block owns ``TILE_Y x TILE_Z`` (y, z) node columns (one warp per y row,
one thread per column) over ``CHUNK_X`` planes along X, and sweeps them
with one halo plane on each side through shared memory
(``csrc/structured.cuh``, namespace ``civi::sweep``).  The CUDA grid is
(z tiles, y tiles, x chunks) over a range of planes ``[p0, p1)`` (K2 and
K6: all of them; K5: the overlap split's ranges); every node of the range
belongs to exactly one block and plane.  K2 and K6 write one f32 triple of
dot partials per block.  The C entry points refuse a geometry that does
not match the constants they were built with.

A chunk of 32 planes re-reads 2 halo planes (6 %) and cuts the 256^3-node
grid into 2,048 blocks, several waves over the H100's 132 SMs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

TILE_Y, TILE_Z = 8, 32
CHUNK_X = 32
# staging buffers in the ring (planes in flight + the one being worked)
STAGES = 3
# shared memory: staged rows of 40 floats (the 34 halo columns, z0 on a
# 16-byte boundary) and mask rows of 40 bytes (10 aligned words)
STAGE_ROW, MASK_ROW = 40, 40
# the most dynamic shared memory one H100 block may take
SMEM_LIMIT = 232_448


@dataclass(frozen=True)
class SweepGeometry:
    tile: Tuple[int, int]  # (y, z) node columns a block owns
    chunk: int  # X planes a block owns
    grid: Tuple[int, int, int]  # CUDA (x, y, z) = (z tiles, y tiles, x chunks)
    threads: int
    smem_bytes: int
    partials_shape: Tuple[int, int]  # (3, blocks)
    planes: Tuple[int, int]  # the X planes [p0, p1) the blocks write

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def owned(self, block, grid_shape):
        """The ``[lo, hi)`` node ranges along (x, y, z) that CUDA block
        ``(bx, by, bz)`` writes, as the kernels compute them."""
        bx, by, bz = block
        _, Y, Z = grid_shape
        ty, tz = self.tile
        p0, p1 = self.planes
        return (
            (p0 + bz * self.chunk, min(p0 + (bz + 1) * self.chunk, p1)),
            (by * ty, min((by + 1) * ty, Y)),
            (bx * tz, min((bx + 1) * tz, Z)),
        )

    def launch_args(self) -> Tuple[int, ...]:
        """(tile_y, tile_z, chunk, grid_x, grid_y, grid_z, smem) as the C
        entry points take them."""
        return (*self.tile, self.chunk, *self.grid, self.smem_bytes)


def sweep_geometry(grid_shape, vectors: int,
                   planes: Optional[Tuple[int, int]] = None) -> SweepGeometry:
    """The geometry of a sweep over the planes ``planes`` = ``[p0, p1)``
    (default all) of the node grid ``grid_shape`` (X, Y, Z) that stages
    ``vectors`` f32 vectors per plane (K1/K5 and K2: 1, x or r; K6: 3, r,
    w and s) besides the mask.  An empty range has no x chunk."""
    X, Y, Z = (int(n) for n in grid_shape)
    if min(X, Y, Z) <= 0:
        raise ValueError(f"grid {grid_shape}: every extent must be positive")
    p0, p1 = (0, X) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= p0 <= p1 <= X:
        raise ValueError(f"plane range [{p0}, {p1}) outside [0, {X})")
    halo_y, halo_z = TILE_Y + 2, TILE_Z + 2
    # STAGES staging buffers (3 channels per vector, 3 mask components)
    # and one transformed plane of 3 components
    smem = (4 * (STAGES * 3 * vectors * halo_y * STAGE_ROW
                 + 3 * halo_y * halo_z)
            + STAGES * 3 * halo_y * MASK_ROW)
    grid = (-(-Z // TILE_Z), -(-Y // TILE_Y), -(-(p1 - p0) // CHUNK_X))
    return SweepGeometry(
        tile=(TILE_Y, TILE_Z), chunk=CHUNK_X, grid=grid,
        threads=TILE_Y * TILE_Z, smem_bytes=smem,
        partials_shape=(3, grid[0] * grid[1] * grid[2]), planes=(p0, p1),
    )


def vector_copies(Z: int, *tensors) -> int:
    """1 when the staged rows move as 16-byte copies (Z % 4 == 0 and every
    tensor 16-byte aligned), else 0 (4-byte copies)."""
    return int(Z % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def sweep_taps32(model) -> np.ndarray:
    """The model's host copy of the taps the sweeps take by value (405 f32:
    ``ops.structured.sweep_taps``)."""
    taps = model.sweep_taps
    if taps is None:
        raise ValueError("model has no sweep_taps (build it with "
                         "build_structured_model or convert)")
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    if taps.shape != (405,):
        raise ValueError(f"sweep_taps: shape {taps.shape}, expected (405,)")
    return taps
