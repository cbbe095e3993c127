"""The collectives of the sharded structured route, with per-call counters.

Port of the purpose of :mod:`civiwave_tpu.parallel.collectives`: the
reference counts the collectives of its compiled PCG body by parsing HLO,
which has no torch meaning.  Here the two collectives the route makes are
functions over ``torch.distributed`` that count their calls, so tests and
``chip_smoke.py`` pin the reference's per-iteration budget directly:

* :func:`ppermute` — ``jax.lax.ppermute``: each ``(src, dst)`` pair sends
  ``src``'s tensor to ``dst``; a rank that receives nothing gets zeros.
  One call is one ghost exchange (2 per matvec on a 1-D group, 4 on a 2-D
  one);
* :func:`psum` — an all-reduce sum (one per fused PCG iteration, of an f64
  ``(3,)`` tensor);
* :func:`all_gather` — every rank's block, concatenated along the first
  axis: the general path's fallback operator gathers the sanitized x once
  per matvec where no halo plan holds (the reference's GSPMD form makes
  the same all-gather implicitly);
* :func:`gather` — every rank's tensor on one rank only: a shard's output,
  probes and checkpoints bring their fields to rank 0, which writes them
  (the reference's arrays are global, so its host fetch is implicit).

``ppermute.calls``, ``psum.calls``, ``psum.shapes`` (a Counter of
``(dtype, shape)``), ``all_gather.calls`` and ``gather.calls`` are plain
counters that only these functions increment; :func:`reset_counts` zeroes
them.  All-gathers of a field for the host (``parallel.sharding.gather``
without ``dst``) are not counted.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist


class Pending:
    """An exchange in flight: :meth:`wait` returns the received tensor."""

    def __init__(self, works, received):
        self._works = works
        self._received = received

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        self._works = []
        return self._received


def ppermute(tensor, pairs, group=None, *, async_op: bool = False):
    """Send ``tensor`` along each ``(src, dst)`` pair of ranks of ``group``
    (the default group if None) and return what this rank receives, zeros
    if it receives nothing.  With ``async_op`` a :class:`Pending` is
    returned instead; the send and the receive run while the caller goes
    on, and ``wait()`` orders the caller's stream after them."""
    rank = dist.get_rank(group)
    received = torch.zeros_like(tensor)
    ops = []
    for src, dst in pairs:
        if src == rank:
            ops.append(dist.P2POp(dist.isend, tensor.contiguous(), dst, group))
        if dst == rank:
            ops.append(dist.P2POp(dist.irecv, received, src, group))
    works = dist.batch_isend_irecv(ops) if ops else []
    ppermute.calls += 1
    pending = Pending(works, received)
    return pending if async_op else pending.wait()


def psum(tensor, group=None):
    """All-reduce sum of ``tensor`` over ``group``, in place; returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    psum.calls += 1
    psum.shapes[(tensor.dtype, tuple(tensor.shape))] += 1
    return tensor


def all_gather(tensor, group=None, count: bool = True) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes), concatenated along dim 0 in
    rank order.  ``count=False``: a gather for host output, not counted."""
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    all_gather.calls += count
    return torch.cat(parts)


def gather(tensor, dst: int = 0, group=None):
    """Every rank's ``tensor`` (equal shapes) as a list in rank order on
    rank ``dst``, None on the others.  One call, counted, whatever the
    group's size (a group of one sends nothing)."""
    gather.calls += 1
    tensor = tensor.contiguous()
    if dist.get_world_size(group) == 1:
        return [tensor]
    rank = dist.get_rank(group)
    parts = ([torch.empty_like(tensor)
              for _ in range(dist.get_world_size(group))]
             if rank == dst else None)
    dist.gather(tensor, parts, dst=dst, group=group)
    return parts


def reset_counts() -> None:
    all_gather.calls = 0
    gather.calls = 0
    ppermute.calls = 0
    psum.calls = 0
    psum.shapes = Counter()


reset_counts()
