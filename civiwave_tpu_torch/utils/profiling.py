"""``--profile``: a torch.profiler trace with the reference's named ranges,
the program's own spans, a count of host syncs and the set-up phases.

The reference's traces carry ``jax.named_scope`` names: the stepper's
``newmark_predictor``, ``effective_rhs``, ``pcg_solve`` and
``newmark_update``, PCG's ``pcg_matvec``, ``pcg_precondition`` and
``pcg_pc_matvec``, and the V-cycle's ``mg_level{li}``.  :func:`scope` opens
the same names, and the program's own spans (``frame``, ``load_update``,
``pc_build``, ``telemetry_read``, ``output_frame``, ``checkpoint_save``,
the PCG iteration's ``pcg_dots``, ``pcg_scalars``, ``pcg_vector_update``
and ``pcg_host_sync``), as ``torch.profiler.record_function`` ranges
inside :func:`trace` only, and is a no-op context otherwise: the
unprofiled PCG loop pays one global read per range and no call into
torch, and a profiler the caller opens itself records the kernels without
the ranges (whose device-side copies would count twice in a busy share).
:func:`launch` puts each launch of the kernel library (``ops/cuda``, C
entry points called through ctypes, which the profiler sees as no
operator) inside an operator range of the entry's name while the ranges
are open, so that its kernels count in the device time of the ranges
around it (``ops/cuda/_build.KernelLibrary.call``, the one launch path).

``host_syncs`` counts the points where the host waits for the device, each
at the line that makes it: a read of device data on the host
(:func:`to_host`: PCG's flag reads, the stepper's telemetry read, output's
and derived fields' copies, a checkpoint's copy), an upload from pageable
host memory (:func:`from_host`: the general path's load), and a phase's
closing :func:`sync`.  On a CUDA device each one blocks the host until the
device's queue ahead of it has run; a host device counts the same points,
where nothing waits, so that a CPU run counts what a CUDA run waits for.
``phases`` holds the host seconds of the set-up phases the benchmark
reads (:func:`phase`): ``build_simulation``'s ``preprocess`` and ``pack``
on the general path, and ``first_frame``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()
_ranges = False  # inside trace()
# the points where the host waits for the device (a plain int, as the
# kernel wrappers' ``.launches``); a frame's increase is its
# ``StepTelemetry.host_syncs``
host_syncs = 0
# name -> host seconds of the set-up phases of the latest build_simulation
# (cleared when it starts) and of its first frame
phases: dict = {}


def tracing() -> bool:
    """Whether :func:`trace` is recording (the named ranges are open)."""
    return _ranges


def scope(name: str):
    """``record_function(name)`` inside :func:`trace`, else a no-op."""
    if _ranges:
        return torch.profiler.record_function(name)
    return _NULL


def launch(name: str):
    """An operator range ``name`` around one launch of the kernel library
    inside :func:`trace` (the profiler links the launched kernels to it,
    so they count in the device time of every range around it), else
    the no-op context of :func:`scope`."""
    if _ranges:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def to_host(tensor: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """``tensor`` in host memory (``copy``: a new tensor even on the host),
    counted in ``host_syncs``: from a CUDA device the copy waits for the
    device's queue."""
    global host_syncs
    host_syncs += 1
    return tensor.to("cpu", copy=copy)


def from_host(rows, device, dtype=torch.float32) -> torch.Tensor:
    """Host ``rows`` (an array) as a tensor of ``dtype`` on ``device``,
    counted in ``host_syncs``: to a CUDA device the copy from pageable
    memory waits for the device's queue."""
    global host_syncs
    host_syncs += 1
    return torch.as_tensor(rows, dtype=dtype, device=device)


def sync(device) -> None:
    """Block the host until ``device`` has run its queued work (a CUDA
    device; a host device has none), counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, device=None):
    """Record the block's host seconds in ``phases[name]``, the block
    inside ``scope(name)``; with a ``device`` (a phase that queues device
    work) the clock stops after :func:`sync`."""
    start = time.perf_counter()
    with scope(name):
        yield
        if device is not None:
            sync(device)
    phases[name] = time.perf_counter() - start


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
