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


def summary(prof, wall_ms: float) -> str:
    """One line on a finished torch.profiler window of ``wall_ms``: the
    device's busy time and share (its kernels and copies only: an
    operator's own row, and the device-side copy of a named range or of
    NCCL's ``nccl:*`` range, repeat the time of what they enclose; the
    profiler stretches the window, so the share is a lower bound), then
    the host operators and the device kernels with the most self time."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    ranges = {e.key for e in host}
    device = [e for e in rows if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)
              and e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3

    def top(events, attr, n):
        events = sorted(events, key=lambda e: getattr(e, attr), reverse=True)
        return "; ".join(f"{e.key[:56]} {getattr(e, attr) / 1e3:.3f} ms "
                         f"x{e.count}" for e in events[:n])

    return (f"{wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms (share "
            f"{busy_ms / wall_ms:.3f}); host by self time: "
            f"{top(host, 'self_cpu_time_total', 8)}; by device time: "
            f"{top(device, 'self_device_time_total', 6)}")


@contextlib.contextmanager
def trace(directory: str, device):
    """Record the block with torch.profiler (CPU activity, and CUDA's on a
    CUDA ``device``) and the named ranges, then write its Chrome trace to
    ``directory/civiwave_<time>_<pid>.trace.json``.  Yields a dict that
    holds, once the block has ended, that file's ``"path"``, the
    ``"profiler"`` and the block's ``"wall_ms"`` (the device synchronized
    at its end), the arguments of :func:`summary`."""
    global _ranges
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    info = {}
    with profile(activities=activities) as prof:
        _ranges = True
        start = time.perf_counter()
        try:
            yield info
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - start) * 1e3
            _ranges = False
    os.makedirs(directory, exist_ok=True)
    info["path"] = os.path.join(
        directory, f"civiwave_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.trace.json")
    prof.export_chrome_trace(info["path"])
    info.update(profiler=prof, wall_ms=wall_ms)
