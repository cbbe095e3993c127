"""Launch geometry of the plane-sweep kernels K1/K5
(``keff_structured_halo``), K2 (``pc_keff_structured``), K6
(``pcg_iteration_structured``), K4 (``interior_stencil``) and G3
(``corner_gather``), and the taps
K1/K5, K2 and K6 take by value.

A block owns ``TILE_Y x TILE_Z`` (y, z) node columns (one warp per y row,
one thread per column) over ``CHUNK_X`` planes along X, and sweeps them
with one halo plane on each side through shared memory
(``csrc/structured.cuh``, namespace ``civi::sweep``).  The CUDA grid is
(z tiles, y tiles, x chunks) over a range of planes ``[p0, p1)`` (K2 and
K6: all of them; K5: the overlap split's ranges); every node of the range
belongs to exactly one block and plane.  K2 and K6 write one f32 triple of
dot partials per block.  The C entry points refuse a geometry that does
not match the constants they were built with.  K1/K5's f64 instance
sweeps the same tiles and chunks with 8-byte elements: only the shared
memory doubles (``elem``), 40,560 bytes against 22,080, and it takes the
taps as doubles (:func:`sweep_taps64`).

A chunk of 32 planes re-reads 2 halo planes (6 %) and cuts the 256^3-node
grid into 2,048 blocks, several waves over the H100's 132 SMs.

K4 stages one sanitized vector and nothing else, and its tile and chunk
follow the grid's shape (:func:`stencil_geometry`): the tile of
``STENCIL_TILES`` that leaves the fewest idle lanes on the (Y, Z) plane
(8 x 32 on a 256^3 grid, 16 x 16 on the soil column's 48 x 48 planes, where
8 x 32 idles a quarter of its lanes), then the longest chunk of
``STENCIL_CHUNKS`` that still gives every SM ``STENCIL_BLOCKS_PER_SM``
blocks, so that the last wave is a small share of the run.

G3 (``corner_gather``, a heterogeneous grid's operator) sweeps K1's tiles
and chunks, and also computes the element forces of the cells its nodes
touch (:func:`corner_gather_geometry`, :func:`corner_gather_cells`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
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
SM_COUNT = 132  # H100 SXM
# K4's (y, z) tiles, each with the floats of one staged row (the halo
# column h at h + 3; a 16-wide tile puts two rows in a warp, and a stride
# of 16 mod 32 floats puts them in different banks), the chunks it may
# take, longest first, and the blocks per SM a chunk must leave.  On an
# H100 the rule picks the fastest of the six on both main-path grids: the
# soil column 16 x 16 / 8 planes (0.0444 ms; 16 x 16 / 16 0.0471, 8 x 32 /
# 32 0.0555), 255^3 8 x 32 / 32 (0.2747 ms; 8 x 32 / 8 0.2930)
STENCIL_TILES = {(8, 32): 40, (16, 16): 48}
STENCIL_CHUNKS = (32, 16, 8)
STENCIL_BLOCKS_PER_SM = 8
# the taps K1/K5, K2 and K6 take by value (``csrc/structured.cuh``
# ``TapsT``): the interior stencil's factored coefficients
# (``ops.structured.factored_taps``), then the z-face ghost taps, 2 x 81
FACTORED_TAPS = 30
SWEEP_TAPS = FACTORED_TAPS + 2 * 81


@dataclass(frozen=True)
class SweepGeometry:
    tile: Tuple[int, int]  # (y, z) node columns a block owns
    chunk: int  # X planes a block owns
    grid: Tuple[int, int, int]  # CUDA (x, y, z) = (z tiles, y tiles, x chunks)
    threads: int
    smem_bytes: int
    planes: Tuple[int, int]  # the X planes [p0, p1) the blocks write

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def partials_shape(self) -> Tuple[int, int]:
        """(3, blocks): the dot partials K2 and K6 write, one f32 triple
        per block."""
        return (3, self.blocks)

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
                   planes: Optional[Tuple[int, int]] = None,
                   elem: int = 4) -> SweepGeometry:
    """The geometry of a sweep over the planes ``planes`` = ``[p0, p1)``
    (default all) of the node grid ``grid_shape`` (X, Y, Z) that stages
    ``vectors`` vectors of ``elem``-byte elements (4: f32, 8: K1/K5's f64
    instance) per plane (K1/K5 and K2: 1, x or r; K6: 3, r, w and s)
    besides the mask.  An empty range has no x chunk."""
    if elem not in (4, 8):
        raise ValueError(f"elem {elem}: the sweeps stage 4- or 8-byte elements")
    X, Y, Z = (int(n) for n in grid_shape)
    if min(X, Y, Z) <= 0:
        raise ValueError(f"grid {grid_shape}: every extent must be positive")
    p0, p1 = (0, X) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= p0 <= p1 <= X:
        raise ValueError(f"plane range [{p0}, {p1}) outside [0, {X})")
    halo_y, halo_z = TILE_Y + 2, TILE_Z + 2
    # STAGES staging buffers (3 channels per vector, 3 mask components)
    # and one transformed plane of 3 components
    smem = (elem * (STAGES * 3 * vectors * halo_y * STAGE_ROW
                    + 3 * halo_y * halo_z)
            + STAGES * 3 * halo_y * MASK_ROW)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory, over {SMEM_LIMIT}")
    grid = (-(-Z // TILE_Z), -(-Y // TILE_Y), -(-(p1 - p0) // CHUNK_X))
    return SweepGeometry(
        tile=(TILE_Y, TILE_Z), chunk=CHUNK_X, grid=grid,
        threads=TILE_Y * TILE_Z, smem_bytes=smem, planes=(p0, p1),
    )


# G3 (``corner_gather``): the node tile, chunk and threads of K1's sweep,
# plus the cell tile those nodes touch (one more row and column, the cells
# at y0 - 1 and z0 - 1), the row stride of its corner forces and lam/mu
# planes, and a staging ring of 2
G3_CELL_TILE = (TILE_Y + 1, TILE_Z + 1)
G3_FORCE_STRIDE = 312
G3_STAGES = 2


def corner_gather_geometry(grid_shape, elem: int = 4,
                           planes: Optional[Tuple[int, int]] = None
                           ) -> SweepGeometry:
    """G3's sweep over the planes ``planes`` = ``[p0, p1)`` (default all)
    of the node grid ``grid_shape`` (X, Y, Z) with ``elem``-byte vectors
    (4: f32, 8: f64): K1's 8 x 32 tiles and 32-plane chunks; shared memory
    for 2 staged planes of x (tile plus halo) and of the mask, 2 sanitized
    node planes, 24 corner-force rows and 2 lam/mu cell planes of
    ``G3_FORCE_STRIDE`` entries, and in f32 the (48, 24) table (f64 holds
    it in registers).  An empty range has no x chunk."""
    if elem not in (4, 8):
        raise ValueError(f"elem {elem}: G3 has f32 and f64 instances")
    X, Y, Z = (int(n) for n in grid_shape)
    if min(X, Y, Z) <= 0:
        raise ValueError(f"grid {grid_shape}: every extent must be positive")
    p0, p1 = (0, X) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= p0 <= p1 <= X:
        raise ValueError(f"plane range [{p0}, {p1}) outside [0, {X})")
    halo = 3 * (TILE_Y + 2) * (TILE_Z + 2)
    smem = (elem * (G3_STAGES * halo + 2 * halo + 24 * G3_FORCE_STRIDE)
            + 4 * G3_STAGES * 2 * G3_FORCE_STRIDE
            + G3_STAGES * 3 * (TILE_Y + 2) * MASK_ROW
            + (4 * 48 * 24 if elem == 4 else 0))
    grid = (-(-Z // TILE_Z), -(-Y // TILE_Y), -(-(p1 - p0) // CHUNK_X))
    return SweepGeometry(
        tile=(TILE_Y, TILE_Z), chunk=CHUNK_X, grid=grid,
        threads=TILE_Y * TILE_Z, smem_bytes=smem, planes=(p0, p1),
    )


@lru_cache(maxsize=64)
def factored_visits(geometry: SweepGeometry, grid_shape, cells,
                    offsets=(0, 0), ghosts=(False, False)) -> Tuple[int, int]:
    """(factored, total): the (thread, plane) visits of the sweep
    ``geometry`` over a block of node grid ``grid_shape`` (Xl, Yl, Z) at
    global node ``offsets`` (x0, y0) of a grid of ``cells`` (nx, ny, nz)
    that take the interior stencil's factored form, and all of them, as the
    kernels decide it (``csrc/structured.cuh`` ``apply_plane``: the
    thread's row and the three output planes of the interior class).
    Each block sweeps its chunk plus the plane on either side where that
    lies in the block or, per side, ``ghosts`` gives a ghost plane (K5)."""
    xl = int(grid_shape[0])
    nx, ny = int(cells[0]), int(cells[1])
    x0, y0 = int(offsets[0]), int(offsets[1])
    gz, gy, gx = geometry.grid
    ty, tz = geometry.tile
    p0, p1 = geometry.planes
    rows = gy * ty
    interior_rows = sum(1 <= y0 + row < ny for row in range(rows))
    factored = total = 0
    for bz in range(gx):
        x_lo = p0 + bz * geometry.chunk
        x_hi = min(x_lo + geometry.chunk, p1)
        jlo = x_lo - 1 if (x_lo > 0 or ghosts[0]) else x_lo
        jhi = x_hi if (x_hi < xl or ghosts[1]) else x_hi - 1
        total += (jhi - jlo + 1) * rows
        # planes whose outputs x0 + j - 1 .. x0 + j + 1 are all interior
        factored += max(0, min(jhi, nx - 2 - x0) - max(jlo, 2 - x0) + 1
                        ) * interior_rows
    threads = gz * tz
    return factored * threads, total * threads


def corner_gather_cells(geometry: SweepGeometry, block, cells):
    """The ``[lo, hi)`` cell ranges along (x, y, z) whose element forces G3's
    block ``(bx, by, bz)`` computes and gathers, as the kernel computes
    them, cut to the grid's ``cells`` (nx, ny, nz): the cell planes between
    its node planes x_lo - 1 .. x_hi and the cell tile of its node tile."""
    bx, by, bz = block
    ty, tz = geometry.tile
    x_lo = geometry.planes[0] + bz * geometry.chunk
    x_hi = min(x_lo + geometry.chunk, geometry.planes[1])
    y0, z0 = by * ty, bx * tz
    return tuple((max(lo, 0), min(hi, n)) for (lo, hi), n in zip(
        ((x_lo - 1, x_hi), (y0 - 1, y0 + ty), (z0 - 1, z0 + tz)), cells))


def _idle_lanes(tile, Y: int, Z: int) -> int:
    ty, tz = tile
    return -(-Y // ty) * ty * -(-Z // tz) * tz - Y * Z


@lru_cache(maxsize=64)
def stencil_geometry(grid_shape, tile=None, chunk=None) -> SweepGeometry:
    """K4's sweep over every plane of the node grid ``grid_shape`` (X, Y,
    Z): the (y, z) tile of ``STENCIL_TILES`` with the fewest idle lanes
    (8 x 32 on a tie), then the longest chunk of ``STENCIL_CHUNKS`` that
    gives ``STENCIL_BLOCKS_PER_SM`` blocks per SM (else the shortest).
    ``tile`` and ``chunk`` override the choice (a measurement's
    candidates); the C entry point refuses a tile it was not built for."""
    X, Y, Z = (int(n) for n in grid_shape)
    if min(X, Y, Z) <= 0:
        raise ValueError(f"grid {grid_shape}: every extent must be positive")
    if tile is None:
        tile = min(STENCIL_TILES,
                   key=lambda t: (_idle_lanes(t, Y, Z), t != (TILE_Y, TILE_Z)))
    tile = tuple(tile)
    if tile not in STENCIL_TILES:
        raise ValueError(f"tile {tile}: K4 is built for {sorted(STENCIL_TILES)}")
    ty, tz = tile
    plane_tiles = -(-Z // tz) * -(-Y // ty)
    if chunk is None:
        enough = STENCIL_BLOCKS_PER_SM * SM_COUNT
        chunk = next((c for c in STENCIL_CHUNKS
                      if plane_tiles * -(-X // c) >= enough), STENCIL_CHUNKS[-1])
    if chunk <= 0:
        raise ValueError(f"chunk {chunk}: must be positive")
    # a ring of STAGES buffers of the 3 components, tile plus halo
    smem = 4 * STAGES * 3 * (ty + 2) * STENCIL_TILES[tile]
    return SweepGeometry(
        tile=tile, chunk=int(chunk), grid=(-(-Z // tz), -(-Y // ty), -(-X // chunk)),
        threads=ty * tz, smem_bytes=smem, planes=(0, X),
    )


def vector_copies(Z: int, *tensors) -> int:
    """1 when the staged rows move as 16-byte copies (Z % 4 == 0 and every
    tensor 16-byte aligned), else 0 (one copy per element).  The rule is the
    same for f64 vectors, whose 16-byte copies move two values: the fast
    path also stages the mask as aligned words found once per thread, which
    needs the plane stride Y * Z, so Z, to be a multiple of 4."""
    return int(Z % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


@lru_cache(maxsize=32)
def _taps64(spacing, lam0: float, mu0: float) -> np.ndarray:
    from .. import structured as ops

    coef = ops.factored_taps(spacing, lam0, mu0).astype(np.float32)
    # interior minus the f32 z-face class rows at dz = 0, exact in f64
    ghost = ops.z_face_ghost_taps(
        coef, ops.class_stencil_table(spacing, lam0, mu0))
    taps = np.concatenate([coef.astype(np.float64), ghost.reshape(-1)])
    taps.setflags(write=False)
    return taps


def sweep_taps64(model) -> np.ndarray:
    """The f64 taps K1/K5's f64 instance takes by value: the model's f32
    factored coefficients widened, then the z-face ghost taps as the exact
    f64 differences between the interior those give and the f32 class-table
    rows of (1, 1, 0) and (1, 1, 2) at dz = 0, so that interior minus ghost
    is the class table's f32 tap (the f32 ghost taps are the f32-rounded
    f64 differences from the f64 class rows)."""
    taps32 = sweep_taps32(model)
    taps = _taps64(tuple(float(h) for h in model.spacing), float(model.lam0),
                   float(model.mu0))
    n = FACTORED_TAPS
    if not np.array_equal(taps[:n], taps32[:n]):
        raise ValueError("sweep_taps do not match the model's class table")
    return taps


def sweep_taps32(model) -> np.ndarray:
    """The model's host copy of the taps the sweeps take by value
    (``SWEEP_TAPS`` f32: ``ops.structured.sweep_taps``)."""
    taps = model.sweep_taps
    if taps is None:
        raise ValueError("model has no sweep_taps (build it with "
                         "build_structured_model or convert)")
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    if taps.shape != (SWEEP_TAPS,):
        raise ValueError(f"sweep_taps: shape {taps.shape}, expected "
                         f"({SWEEP_TAPS},)")
    return taps
