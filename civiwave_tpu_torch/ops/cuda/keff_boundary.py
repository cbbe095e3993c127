"""Wrapper of the boundary/envelope kernel G2, with its plain version.

G2, ``keff_boundary`` (``csrc/keff_boundary.cu``), stands for the XLA code
the reference runs around ``interior_stencil_pallas`` (K4) on its slender
route (civiwave_tpu/ops/structured.py:449-471 and :607-609): from K4's
output it makes the complete operator,
``bc ? x : ss * (interior - corr) + mf * mass * xs``, where ``corr`` is
each boundary node's ghost taps (``ops/structured.ghost_stencil_table``)
applied to the sanitized neighbours.

One launch, two kinds of block (:func:`boundary_geometry`): envelope
blocks stream over every node and write the interior-class nodes and the
constrained components; face blocks own the free components of the
boundary nodes, face by face, and apply only the nonzero in-grid ghost taps
of each node's class (:func:`ghost_tap_rows`): a thread per x- or y-face
node, a block per 16 x 16 tile of a z face staged through shared memory.
Each output element is written once.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``keff_boundary.launches`` counts launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import _build, plane_sweep

BOUNDARY_THREADS = 256  # threads per block, every kind
SLAB = 16  # X planes per slab of envelope blocks
TILE = 16  # a z-face block's tile: TILE x TILE (x, y) nodes
INTERIOR_CLASS = 13  # class (1, 1, 1): no ghost taps
Z_FACE_CLASSES = (12, 14)  # (1, 1, 0) and (1, 1, 2): taps by value


def keff_boundary_plain(model, interior, x, stiffness_scale, mass_factor):
    """Plain PyTorch G2: the reference's face corrections (edge and corner
    terms folded in) subtracted from ``interior``, then scale, mass term
    and identity rows."""
    from ..structured import keff_envelope, subtract_face_corrections

    xs = x.masked_fill(model.bc_mask, 0.0)
    stiff = subtract_face_corrections(model, xs, interior.clone())
    return keff_envelope(model, x, xs, stiff, stiffness_scale, mass_factor)


# the neighbour offsets that lie on the model along an axis, by the node's
# class there: the low face has none below it, the high face (and the dead
# pad beyond it, constrained) none above
_IN_GRID = {0: (0, 1), 1: (-1, 0, 1), 2: (-1, 0)}


@lru_cache(maxsize=16)
def ghost_tap_rows(spacing, lam0: float, mu0: float):
    """Each boundary class's nonzero ghost taps at the neighbours that lie
    on the model: ``codes`` (27, 10) int32 — the count, then up to 9
    offset codes ``(dx+1)*9 + (dy+1)*3 + (dz+1)`` in increasing order — and
    ``rows`` (27, 9, 9) f32, the 3x3 blocks of ``ghost_stencil_table`` at
    those offsets ([b][c] flat), zero past the count.  A face or an edge
    has 9, a corner 7: the neighbours that share one of the node's boundary
    planes.  The interior class has none.  An offset off the model reads
    zero in K4 and needs no correction."""
    from ..structured import ghost_stencil_table

    ghost = ghost_stencil_table(tuple(spacing), lam0, mu0)
    codes = np.zeros((27, 10), dtype=np.int32)
    rows = np.zeros((27, 9, 9), dtype=np.float32)
    for cls, classes in enumerate(np.ndindex(3, 3, 3)):
        k = 0
        for d in np.ndindex(3, 3, 3):
            if any(d[a] - 1 not in _IN_GRID[classes[a]] for a in range(3)):
                continue
            code = (d[0] * 3 + d[1]) * 3 + d[2]
            if not ghost[cls, code].any():
                continue
            codes[cls, 1 + k] = code
            rows[cls, k] = ghost[cls, code].reshape(9)
            k += 1
        codes[cls, 0] = k
    return codes, rows


@lru_cache(maxsize=16)
def z_face_taps(spacing, lam0: float, mu0: float) -> np.ndarray:
    """The (162,) f32 taps G2 takes by value: the rows of the z-face
    classes (1, 1, 0) and (1, 1, 2), whose 9 offsets are dz = 0 in (dx, dy)
    order, as [side][dx+1][dy+1][b][c]; the plane sweeps' own z-face ghost
    taps (``ops.structured.sweep_taps``)."""
    from ..structured import sweep_taps

    codes, _ = ghost_tap_rows(tuple(spacing), lam0, mu0)
    in_plane = [(dx * 3 + dy) * 3 + 1 for dx in range(3) for dy in range(3)]
    for cls in Z_FACE_CLASSES:
        if codes[cls, 0] != 9 or list(codes[cls, 1:]) != in_plane:
            raise ValueError(f"class {cls}: ghost taps off the z face")
    taps = sweep_taps(tuple(spacing), lam0, mu0)[plane_sweep.FACTORED_TAPS:]
    return np.ascontiguousarray(taps)


@lru_cache(maxsize=16)
def _device_tables(spacing, lam0: float, mu0: float, device):
    """:func:`ghost_tap_rows` on ``device``, uploaded once."""
    codes, rows = ghost_tap_rows(tuple(spacing), lam0, mu0)
    return (torch.as_tensor(codes, device=device),
            torch.as_tensor(rows, device=device))


@dataclass(frozen=True)
class BoundaryGeometry:
    """G2's launch, ``BOUNDARY_THREADS`` threads per block: first
    ``xy_blocks`` blocks of x- and y-face threads (thread t takes node
    :meth:`face_coords` ``[t]``: the x-face planes, x = 0 then x >= nx,
    whole; then for each interior x the y-face rows, y = 0 then y >= ny),
    then for each slab of ``SLAB`` X planes ``slab_envelope`` envelope
    blocks over the slab's nodes (four per thread with ``vec``, else one)
    and ``slab_z`` z-face blocks: side (z = 0, then z = nz) by ``TILE``-wide
    y tiles from y = 1, each a ``TILE`` x ``TILE`` (x, y) tile at x = 16 s
    of the slab's x range with x in [1, nx) and y in [1, ny), y fastest."""

    grid_shape: Tuple[int, int, int]
    cells: Tuple[int, int, int]
    vec: int

    @property
    def x_planes(self) -> int:
        return self.grid_shape[0] - self.cells[0] + 1

    @property
    def y_rows(self) -> int:
        return self.grid_shape[1] - self.cells[1] + 1

    @property
    def xy_nodes(self) -> int:
        """Nodes of the x faces, then of the y faces."""
        _, Y, Z = self.grid_shape
        return (self.x_planes * Y + (self.cells[0] - 1) * self.y_rows) * Z

    @property
    def xy_blocks(self) -> int:
        return -(-self.xy_nodes // BOUNDARY_THREADS)

    @property
    def slabs(self) -> int:
        return -(-self.grid_shape[0] // SLAB)

    @property
    def slab_envelope(self) -> int:
        _, Y, Z = self.grid_shape
        per_block = BOUNDARY_THREADS * (4 if self.vec else 1)
        return -(-SLAB * Y * Z // per_block)

    @property
    def z_tiles_y(self) -> int:
        nx, ny, _ = self.cells
        return -(-(ny - 1) // TILE) if nx > 1 else 0

    @property
    def slab_z(self) -> int:
        return 2 * self.z_tiles_y

    @property
    def blocks(self) -> int:
        return self.xy_blocks + self.slabs * (self.slab_envelope + self.slab_z)

    def launch_args(self) -> Tuple[int, ...]:
        """(x_planes, y_rows, xy_nodes, xy_blocks, slabs, slab_envelope,
        slab_z, vec) as the C entry point takes them."""
        return (self.x_planes, self.y_rows, self.xy_nodes, self.xy_blocks,
                self.slabs, self.slab_envelope, self.slab_z, self.vec)

    def face_coords(self):
        """(ix, iy, iz) int64 arrays of the boundary nodes the face
        threads take, in launch order: the x- and y-face threads, then the
        z-face blocks' valid threads, slab by slab."""
        X, Y, Z = self.grid_shape
        nx, ny, nz = self.cells
        t = np.arange(self.x_planes * Y * Z)
        p, r = np.divmod(t, Y * Z)
        parts = [(np.where(p == 0, 0, nx + p - 1), r // Z, r % Z)]
        t = np.arange(self.xy_nodes - len(t))
        row, iz = np.divmod(t, Z)
        px, q = np.divmod(row, self.y_rows)
        parts.append((1 + px, np.where(q == 0, 0, ny + q - 1), iz))
        i, j = np.divmod(np.arange(TILE * TILE), TILE)
        for s in range(self.slabs):
            for q in range(self.slab_z):
                side, ty = divmod(q, self.z_tiles_y)
                ix, iy = SLAB * s + i, 1 + TILE * ty + j
                ok = (ix >= 1) & (ix < nx) & (iy < ny)
                iz = np.full(int(ok.sum()), 0 if side == 0 else nz)
                parts.append((ix[ok], iy[ok], iz))
        return tuple(np.concatenate(axis).astype(np.int64) for axis in zip(*parts))

    def envelope_nodes(self) -> np.ndarray:
        """How many envelope threads take each node, (X, Y, Z)."""
        X, Y, Z = self.grid_shape
        per = 4 if self.vec else 1
        taken = np.zeros(X * Y * Z, dtype=np.int64)
        for s in range(self.slabs):
            first = s * SLAB * Y * Z
            last = min(first + SLAB * Y * Z, X * Y * Z)
            starts = first + per * np.arange(self.slab_envelope * BOUNDARY_THREADS)
            for k in range(per):
                n = starts[starts < last] + k
                np.add.at(taken, n[n < last], 1)
        return taken.reshape(X, Y, Z)

    def envelope_owned(self, bc: np.ndarray) -> np.ndarray:
        """(3, X, Y, Z) bool: the outputs the envelope writes (every
        component of an interior-class node, and every constrained one);
        the face threads write the rest."""
        return bc | (node_classes(self.grid_shape, self.cells) == INTERIOR_CLASS)[None]


def node_classes(grid_shape, cells) -> np.ndarray:
    """(X, Y, Z) int: each node's boundary class (cx * 3 + cy) * 3 + cz."""
    from ..structured import axis_classes

    cx, cy, cz = (axis_classes(n, c) for n, c in zip(grid_shape, cells))
    return (cx[:, None, None] * 3 + cy[None, :, None]) * 3 + cz[None, None, :]


@lru_cache(maxsize=64)
def boundary_geometry(grid_shape, cells, vec: int) -> BoundaryGeometry:
    """G2's launch geometry on the node grid ``grid_shape`` of a model of
    ``cells`` (nx, ny, nz): X and Y may carry dead pad planes and rows
    beyond nx and ny, Z none."""
    X, Y, Z = (int(n) for n in grid_shape)
    nx, ny, nz = (int(n) for n in cells)
    if min(nx, ny, nz) < 1 or X <= nx or Y <= ny or Z != nz + 1:
        raise ValueError(f"grid {grid_shape} does not hold cells {cells}")
    if 3 * X * Y * Z >= 2**31:
        raise ValueError(f"grid {grid_shape}: G2 indexes nodes in 32 bits")
    return BoundaryGeometry((X, Y, Z), (nx, ny, nz), int(vec))


def keff_boundary(model, interior, x, stiffness_scale, mass_factor):
    """G2: K_eff * x from K4's ``interior`` = stencil(xs); kernel on CUDA,
    plain version on CPU."""
    if x.device.type == "cpu":
        return keff_boundary_plain(
            model, interior, x, stiffness_scale, mass_factor
        )
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    shape = model.vector_shape
    _build.check_tensor(interior, "interior", shape, torch.float32, dev)
    _build.check_tensor(x, "x", shape, torch.float32, dev)
    _build.check_tensor(model.bc_mask, "bc_mask", shape, torch.bool, dev)
    out = torch.empty_like(x)
    X, Y, Z = model.grid_shape
    vec = int(Z % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in (interior, x, out))
              and model.bc_mask.data_ptr() % 4 == 0)
    geom = boundary_geometry(model.grid_shape, (model.nx, model.ny, model.nz), vec)
    codes, rows = _device_tables(model.spacing, model.lam0, model.mu0, dev)
    ztaps = z_face_taps(model.spacing, model.lam0, model.mu0)
    library = _build.load_library()
    library.call(
        "civi_keff_boundary", dev, interior.data_ptr(), x.data_ptr(),
        model.bc_mask.data_ptr(), codes.data_ptr(), rows.data_ptr(),
        ztaps.ctypes.data, out.data_ptr(), X, Y, Z, model.nx, model.ny,
        model.nz, float(np.float32(stiffness_scale)),
        float(np.float32(mass_factor)), float(np.float32(model.m8)),
        *geom.launch_args(),
    )
    keff_boundary.launches += 1
    return out


keff_boundary.launches = 0
