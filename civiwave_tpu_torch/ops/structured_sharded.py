"""The sharded structured operator: ghost exchange + the shard kernel K5
(G3 on a heterogeneous grid).

Port of :mod:`civiwave_tpu.ops.structured_sharded`.  The grid is cut into
X-slabs over a 1-D group or (X, Y) tiles over a 2-D group
(``parallel/sharding.py``); per matvec each rank exchanges the edge planes
of ``x`` with its X neighbours (and, in 2-D, first its edge rows with its
Y neighbours), then runs K5 (``ops/cuda/keff_halo.py``) on its block.  The
mask's ghosts were exchanged once, at shard time (``model.bc_ghosts``).

* 1-D (the reference's ``_exchange_ghost_planes`` + ``_local_keff``): two
  ghost exchanges per matvec, one raw ``(3, Yl, Z)`` plane each way.
* 2-D (``_exchange_ghosts_2d`` + ``_local_keff_2d``): four per matvec, the
  ghost rows ``(3, Xl, Z)`` along Y first, then the Y-extended planes
  ``(3, Yl + 2, Z)`` along X, whose end rows carry the diagonal
  neighbours' corners over two hops.
* The overlap split (``_local_keff_overlap``, ``CIVIWAVE_HALO_OVERLAP``,
  default on; slabs of at least 4 planes): K5 on the interior planes
  ``[1, Xl - 1)`` is launched before the X exchange is waited on, since
  those planes read no X ghost; planes 0 and Xl - 1 follow the wait.
  Three launches per matvec instead of one.

A heterogeneous grid (per-cell λ/μ; the reference keeps it on its GSPMD
corner-gather form, whose exchanges are implicit) runs G3
(``ops/cuda/corner_gather.py``) in K5's place, with the same ghosts, the same single launch or overlap
split and the same exchanges per matvec.  A node also needs the cells
below its block, which a rank does not own (cell (ci, cj) lives with node
(ci, cj)): the last cell plane of the previous slab (in 2-D Y-extended by
its corner cell) and, on a tile, the last cell row of the tile below.
They are exchanged once, at shard time (:func:`exchange_cell_ghosts`, one
exchange in 1-D, two in 2-D), and kept on the model (``cell_ghosts``).

A rank that receives nothing (a global end) gets ``ppermute``'s zeros,
which read as a zero free neighbour: exactly the reference's zero fill.
Divergences from the reference: a node's taps come from its class at its
global coordinate (no ``x_lo``/``x_hi`` face indices, no ``oy_lo``/
``oy_hi`` ownership scalars); the ghosts stay in their own buffers (no
ghost-padded copy of the block per matvec); every shard takes K5 (G3) on
CUDA and its plain version on the CPU (no GSPMD fallback for small 2-D planes,
no TPU-backend or VMEM gates).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..parallel.collectives import ppermute
from .cuda import corner_gather as _g3
from .cuda import keff_halo as _k5


class Ghosts(NamedTuple):
    """A shard's ghost buffers: X planes below plane 0 / above plane Xl - 1
    (``(3, Yl, Z)``; ``(3, Yl + 2, Z)`` in 2-D) and, in 2-D, Y rows below
    row 0 / above row Yl - 1 (``(3, Xl, Z)``).  None reads as zero."""

    x_lo: Optional[torch.Tensor]
    x_hi: Optional[torch.Tensor]
    y_lo: Optional[torch.Tensor] = None
    y_hi: Optional[torch.Tensor] = None


class CellGhosts(NamedTuple):
    """A heterogeneous shard's ghost cells, λ then μ along the first axis:
    the cell plane below plane 0 (``(2, cell_y + gy, nz)`` from cell row
    -gy, gy = 1 in 2-D, so that it carries the corner cell) and, in 2-D,
    the cell row below row 0 (``(2, Xl, nz)``); ``cell_y`` is the block's
    own cell rows.  Zero past the global ends."""

    x_lo: torch.Tensor
    y_lo: Optional[torch.Tensor] = None


def _overlap_enabled() -> bool:
    """The interior/boundary split (the reference's ADR-28): on unless
    ``CIVIWAVE_HALO_OVERLAP`` is 0.  The default is the reference's; on
    four H100s at 255^3 the split measured slower than one launch (its
    two extra launches cost host time), and the default is an open
    ``perf_opt`` item (ROADMAP §B, the sharded route)."""
    return os.environ.get("CIVIWAVE_HALO_OVERLAP", "1") != "0"


def _split(x_local: int) -> bool:
    return _overlap_enabled() and x_local >= 4


def _exchange_rows(block, group):
    """2-D: this tile's Y ghost rows — the last row of the tile below, the
    first row of the tile above (two exchanges, waited)."""
    y_lo = ppermute(block[:, :, -1], group.pairs(1, +1))
    y_hi = ppermute(block[:, :, 0], group.pairs(1, -1))
    return y_lo, y_hi


def _start_plane_exchange(block, y_lo, y_hi, group):
    """Start the two X exchanges: the last plane goes to the next slab
    (its ``x_lo``), the first to the previous one (its ``x_hi``); in 2-D
    each plane is Y-extended by the rows just received.  Returns the two
    pending receives."""
    last, first = block[:, -1], block[:, 0]
    if y_lo is not None:
        last = torch.cat([y_lo[:, -1:], last, y_hi[:, -1:]], dim=1)
        first = torch.cat([y_lo[:, :1], first, y_hi[:, :1]], dim=1)
    return (ppermute(last, group.pairs(0, +1), async_op=True),
            ppermute(first, group.pairs(0, -1), async_op=True))


def exchange_ghosts(block, group) -> Ghosts:
    """Every ghost of ``block`` (a vector, or the mask as uint8), waited."""
    y_lo = y_hi = None
    if group.two_d:
        y_lo, y_hi = _exchange_rows(block, group)
    lo, hi = _start_plane_exchange(block, y_lo, y_hi, group)
    return Ghosts(lo.wait(), hi.wait(), y_lo, y_hi)


def cut_ghosts(g, x0: int, y0: int, xl: int, yl: int, two_d: bool) -> Ghosts:
    """The ghosts that :func:`exchange_ghosts` delivers to tile ``(x0, y0)``
    of extents ``(xl, yl)``, cut instead from the global node-grid tensor
    ``g`` ``(3, X, Y, Z)``: the neighbours' edge planes (Y-extended in
    2-D) and rows, zero past the global ends.  For checks in one process,
    without a group."""
    _, gx, gy, z = g.shape
    pad = g.new_zeros((3, gx + 2, gy + 2, z))
    pad[:, 1:-1, 1:-1] = g
    e = int(two_d)
    rows = slice(y0 + 1 - e, y0 + 1 + yl + e)
    ghosts = Ghosts(pad[:, x0, rows].contiguous(),
                    pad[:, x0 + xl + 1, rows].contiguous())
    if two_d:
        cols = slice(x0 + 1, x0 + 1 + xl)
        ghosts = ghosts._replace(y_lo=pad[:, cols, y0].contiguous(),
                                 y_hi=pad[:, cols, y0 + yl + 1].contiguous())
    return ghosts


def exchange_cell_ghosts(lam, mu, group) -> CellGhosts:
    """The ghost cells of a heterogeneous shard's cell grids ``lam`` and
    ``mu`` (``(Xl, cell_y, nz)``): on a tile the last cell row goes to the
    tile above first, then the last cell plane, Y-extended by the row just
    received, to the next slab (one exchange in 1-D, two in 2-D,
    waited)."""
    cells = torch.stack([lam, mu])
    y_lo = None
    if group.two_d:
        y_lo = ppermute(cells[:, :, -1], group.pairs(1, +1))
    last = cells[:, -1]
    if y_lo is not None:
        last = torch.cat([y_lo[:, -1:], last], dim=1)
    return CellGhosts(ppermute(last, group.pairs(0, +1)), y_lo)


def cut_cell_ghosts(lam_grid, mu_grid, x0: int, y0: int, xl: int, yl: int,
                    two_d: bool) -> CellGhosts:
    """The ghost cells that :func:`exchange_cell_ghosts` delivers to tile
    ``(x0, y0)`` of node extents ``(xl, yl)``, cut instead from the global
    cell grids ``(X, cell_y, nz)``, zero past the global ends.  For checks
    in one process, without a group."""
    cells = torch.stack([lam_grid, mu_grid])
    _, gx, cy, nz = cells.shape
    pad = cells.new_zeros((2, gx + 1, cy + 1, nz))
    pad[:, 1:, 1:] = cells
    rows = min(cy - y0, yl)  # the tile's own cell rows
    e = int(two_d)
    ghosts = CellGhosts(pad[:, x0, y0 + 1 - e:y0 + 1 + rows].contiguous())
    if two_d:
        ghosts = ghosts._replace(y_lo=pad[:, x0 + 1:x0 + 1 + xl, y0].contiguous())
    return ghosts


def _operator(model, x, ghosts, stiffness_scale, mass_factor, planes=None,
              out=None):
    """One launch of the shard's operator kernel: K5, or G3 on a
    heterogeneous grid."""
    if model.homogeneous:
        return _k5.keff_structured_halo(
            model, x, ghosts, stiffness_scale, mass_factor, planes, out
        )
    return _g3.apply_keff_corner_gather(
        model, x, stiffness_scale, mass_factor, ghosts, planes, out
    )


def _keff(model, x, y_rows, x_planes, stiffness_scale, mass_factor):
    """K5 (G3) over the shard with its Y ghost rows at hand; ``x_planes()``
    returns the X ghost planes, waiting for them: after the interior
    launch where the overlap split applies, before the one launch where
    not."""
    xl = model.grid_shape[0]
    if not _split(xl):
        ghosts = Ghosts(*x_planes(), *y_rows)
        return _operator(model, x, ghosts, stiffness_scale, mass_factor)
    out = _operator(
        model, x, Ghosts(None, None, *y_rows), stiffness_scale, mass_factor,
        planes=(1, xl - 1),
    )
    ghosts = Ghosts(*x_planes(), *y_rows)
    for planes in ((0, 1), (xl - 1, xl)):
        _operator(model, x, ghosts, stiffness_scale, mass_factor, planes, out)
    return out


def local_keff(model, x, ghosts: Ghosts, stiffness_scale, mass_factor):
    """K_eff * x on one shard whose ghosts are at hand (no group): one K5
    (G3) launch, or the overlap split's three."""
    return _keff(model, x, (ghosts.y_lo, ghosts.y_hi),
                 lambda: (ghosts.x_lo, ghosts.x_hi), stiffness_scale,
                 mass_factor)


def apply_keff_structured_sharded(model, x, stiffness_scale, mass_factor):
    """K_eff * x on this rank's shard: the ghost exchange of its group
    (2 or 4 ``ppermute`` calls) and K5 (G3), with the interior planes launched
    before the X planes arrive where the overlap split applies.  A
    collective: every rank of the group calls it."""
    group = model.shard_group
    y_lo = y_hi = None
    if group.two_d:
        y_lo, y_hi = _exchange_rows(x, group)
    lo, hi = _start_plane_exchange(x, y_lo, y_hi, group)
    return _keff(model, x, (y_lo, y_hi), lambda: (lo.wait(), hi.wait()),
                 stiffness_scale, mass_factor)
