"""``--profile``: a torch.profiler trace with the reference's named ranges.

The reference's traces carry ``jax.named_scope`` names: the stepper's
``newmark_predictor``, ``effective_rhs``, ``pcg_solve`` and
``newmark_update``, PCG's ``pcg_matvec``, ``pcg_precondition`` and
``pcg_pc_matvec``, and the V-cycle's ``mg_level{li}``.  :func:`scope` opens
the same names as ``torch.profiler.record_function`` ranges inside
:func:`trace` only, and is a no-op context otherwise: the unprofiled PCG
loop pays one global read per range and no call into torch, and a
profiler the caller opens itself records the kernels without the ranges
(whose device-side copies would count twice in a busy share).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()
_ranges = False  # inside trace()


def tracing() -> bool:
    """Whether :func:`trace` is recording (the named ranges are open)."""
    return _ranges


def scope(name: str):
    """``record_function(name)`` inside :func:`trace`, else a no-op."""
    if _ranges:
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def trace(directory: str, device):
    """Record the block with torch.profiler (CPU activity, and CUDA's on a
    CUDA ``device``) and the named ranges, then write its Chrome trace to
    ``directory/civiwave_<time>_<pid>.trace.json``.  Yields a dict whose
    ``"path"`` is that file once the block has ended."""
    global _ranges
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    info = {}
    with profile(activities=activities) as prof:
        _ranges = True
        try:
            yield info
        finally:
            _ranges = False
    os.makedirs(directory, exist_ok=True)
    info["path"] = os.path.join(
        directory, f"civiwave_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.trace.json")
    prof.export_chrome_trace(info["path"])
