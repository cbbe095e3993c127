"""The general path's K_eff on a shard: banded halo exchange + K7 + G1.

Port of :mod:`civiwave_tpu.ops.general_sharded`.  A shard
(``parallel.sharding.shard_general``) holds L = N*/S contiguous node rows
and the elements whose min corner it owns; every node those elements touch
lies in its (L + G)-row window (``parallel/general_halo.py``).  Per matvec
(:func:`apply_keff_general_sharded`):

1. sanitize the first G rows of x and send them to the previous rank (one
   ``ppermute``): they are the next block's rows of this rank's window;
2. K7 over the window's elements, then G1 over its L + G rows, from the
   shard's own force rows (``shard_window``, a PackedModel of L + G rows:
   this rank's mask and mass, then the next rank's mask rows, exchanged
   once at shard time, and zero mass);
3. send the G ghost-row partial sums to the next rank (the second
   ``ppermute``) and add what the previous rank sent to rows [0, G).

G1 finishes every row as the single-device operator does (``bc ? x :
assembled + mf m xs``), so the ghost rows carry their partial sums (zero
mass) and the received partials are added after the finish, as
``where(bc, out, out + recv)``: a constrained row stays exactly x, and one
G1 launch serves the shard (the reference adds them between its assembly
and finish).  The row-local dashpot term follows, as on one device.

Where no plan holds (mixed blocks, G > L, ``CIVIWAVE_GENERAL_HALO=0``) the
reference runs GSPMD row sharding; the port's counterpart gathers the
sanitized x from every rank (one counted ``all_gather``), runs K7 + G1
over the whole model and keeps its own rows (:func:`_gathered_keff`).

The block-Jacobi node blocks of a halo shard take the same route: the
window's blocks, then the ghost rows' partial blocks forward (one
``ppermute`` per build, i.e. per dt change).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather, ppermute
from . import block_jacobi
from .apply_keff import add_dashpot_term, elastic_keff, sanitize


def window_x(x: torch.Tensor, ghost) -> torch.Tensor:
    """The (L + G, 3) window of x: this shard's rows, then the next
    shard's first G sanitized rows (``ghost``; None when G = 0)."""
    return x if ghost is None else torch.cat([x, ghost])


def window_keff(model, x, ghost, stiffness_scale, mass_factor):
    """K7 + G1 over the window: (L + G, 3), rows L.. the ghost rows'
    partial sums."""
    return elastic_keff(model.shard_window, window_x(x, ghost),
                        stiffness_scale, mass_factor)


def add_ghost_partials(model, out_ext, recv):
    """This shard's (L, 3) rows of ``out_ext`` with the previous shard's
    ghost-row partials ``recv`` (None: none) added to rows [0, G) that are
    free; constrained rows keep x."""
    out = out_ext[:model.local_rows]
    if recv is not None:
        head = out[:model.halo_ghost]
        head.copy_(torch.where(model.bc_mask[:model.halo_ghost], head,
                               head + recv))
    return out


def _halo_keff(model, x, stiffness_scale, mass_factor):
    group, L, G = model.shard_group, model.local_rows, model.halo_ghost
    ghost = recv = None
    if G:
        head = torch.where(model.bc_mask[:G], 0.0, x[:G])
        ghost = ppermute(head, group.pairs(0, -1))
    out_ext = window_keff(model, x, ghost, stiffness_scale, mass_factor)
    if G:
        recv = ppermute(out_ext[L:], group.pairs(0, +1))
    return add_ghost_partials(model, out_ext, recv if group.rank else None)


def _gathered_keff(model, x, stiffness_scale, mass_factor):
    full = all_gather(sanitize(model, x))
    out = elastic_keff(model.shard_window, full, stiffness_scale, mass_factor)
    return torch.where(model.bc_mask, x, model.own_rows(out))


def apply_keff_general_sharded(model, x, stiffness_scale, mass_factor):
    """K_eff * x on this rank's rows: the halo form (2 ``ppermute`` calls
    when G > 0) or the all-gather form (1 ``all_gather``), then the
    dashpot term.  A collective: every rank of the group calls it."""
    keff = _halo_keff if model.halo else _gathered_keff
    out = keff(model, x, stiffness_scale, mass_factor)
    return add_dashpot_term(model, out, x)


def node_blocks_general_sharded(model, stiffness_scale, mass_factor):
    """This rank's (L, 3, 3) K_eff node blocks: the window's, with the
    previous rank's ghost-row partial blocks added (halo form), or this
    rank's rows of the whole model's (all-gather form).  A collective."""
    blocks = block_jacobi.assemble_node_blocks(
        model.shard_window, stiffness_scale, mass_factor)
    if not model.halo:
        return model.own_rows(blocks)
    L, G, group = model.local_rows, model.halo_ghost, model.shard_group
    out = blocks[:L]
    if G:
        recv = ppermute(blocks[L:].contiguous(), group.pairs(0, +1))
        if group.rank:
            out[:G] += recv
    return out
