"""The sharded structured operator: ghost exchange + the shard kernel K5.

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

A rank that receives nothing (a global end) gets ``ppermute``'s zeros,
which read as a zero free neighbour: exactly the reference's zero fill.
Divergences from the reference: a node's taps come from its class at its
global coordinate (no ``x_lo``/``x_hi`` face indices, no ``oy_lo``/
``oy_hi`` ownership scalars); the ghosts stay in their own buffers (no
ghost-padded copy of the block per matvec); every shard takes K5 on CUDA
and its plain version on the CPU (no GSPMD fallback for small 2-D planes,
no TPU-backend or VMEM gates).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..parallel.collectives import ppermute
from .cuda import keff_halo as _k5


class Ghosts(NamedTuple):
    """A shard's ghost buffers: X planes below plane 0 / above plane Xl - 1
    (``(3, Yl, Z)``; ``(3, Yl + 2, Z)`` in 2-D) and, in 2-D, Y rows below
    row 0 / above row Yl - 1 (``(3, Xl, Z)``).  None reads as zero."""

    x_lo: Optional[torch.Tensor]
    x_hi: Optional[torch.Tensor]
    y_lo: Optional[torch.Tensor] = None
    y_hi: Optional[torch.Tensor] = None


def _overlap_enabled() -> bool:
    """The interior/boundary split (the reference's ADR-28): on unless
    ``CIVIWAVE_HALO_OVERLAP`` is 0.  The default is the reference's; on
    four H100s at 255^3 the split measured slower than one launch (its
    two extra launches cost host time), and the default is an open
    ``perf_opt`` item (ROADMAP A11)."""
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


def _keff(model, x, y_rows, x_planes, stiffness_scale, mass_factor):
    """K5 over the shard with its Y ghost rows at hand; ``x_planes()``
    returns the X ghost planes, waiting for them: after the interior
    launch where the overlap split applies, before the one launch where
    not."""
    xl = model.grid_shape[0]
    if not _split(xl):
        ghosts = Ghosts(*x_planes(), *y_rows)
        return _k5.keff_structured_halo(
            model, x, ghosts, stiffness_scale, mass_factor
        )
    out = _k5.keff_structured_halo(
        model, x, Ghosts(None, None, *y_rows), stiffness_scale, mass_factor,
        planes=(1, xl - 1),
    )
    ghosts = Ghosts(*x_planes(), *y_rows)
    for planes in ((0, 1), (xl - 1, xl)):
        _k5.keff_structured_halo(
            model, x, ghosts, stiffness_scale, mass_factor, planes, out
        )
    return out


def local_keff(model, x, ghosts: Ghosts, stiffness_scale, mass_factor):
    """K_eff * x on one shard whose ghosts are at hand (no group): one K5
    launch, or the overlap split's three."""
    return _keff(model, x, (ghosts.y_lo, ghosts.y_hi),
                 lambda: (ghosts.x_lo, ghosts.x_hi), stiffness_scale,
                 mass_factor)


def apply_keff_structured_sharded(model, x, stiffness_scale, mass_factor):
    """K_eff * x on this rank's shard: the ghost exchange of its group
    (2 or 4 ``ppermute`` calls) and K5, with the interior planes launched
    before the X planes arrive where the overlap split applies.  A
    collective: every rank of the group calls it."""
    group = model.shard_group
    y_lo = y_hi = None
    if group.two_d:
        y_lo, y_hi = _exchange_rows(x, group)
    lo, hi = _start_plane_exchange(x, y_lo, y_hi, group)
    return _keff(model, x, (y_lo, y_hi), lambda: (lo.wait(), hi.wait()),
                 stiffness_scale, mass_factor)
