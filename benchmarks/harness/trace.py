"""Reading a torch.profiler window: device busy time, the program's named
ranges, kernels by name, and the idle gaps by what the host was doing.

The busy rule is the program's own (``utils/profiling.summary``): the
device's kernels, copies and sets only; an operator's own device row and
the device-side copy of a named range repeat the time of what they enclose
and are left out.  The profiler stretches the window, so the busy share is
a lower bound.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# the program's ranges (utils/profiling.py), opened only while it traces
STEPPER_RANGES = ("newmark_predictor", "effective_rhs", "newmark_update")
PCG_RANGE = "pcg_solve"


@dataclass
class TraceSummary:
    wall_s: float
    busy_s: float
    # CPU rows of the named ranges: name -> (host us, device us, count)
    ranges: dict = field(default_factory=dict)
    # device rows: name -> (device us, count)
    kernels: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]]

    def kernel_time(self, patterns) -> tuple:
        """(device seconds, launches) of the kernels whose names hold any
        of ``patterns``."""
        hits = [v for k, v in self.kernels.items() if any(p in k for p in patterns)]
        return sum(h[0] for h in hits) / 1e6, sum(h[1] for h in hits)

    def device_ops(self, n: int = 10) -> list:
        top = sorted(self.kernels.items(), key=lambda kv: kv[1][0], reverse=True)
        return [[k[:120], v[0] / 1e6] for k, v in top[:n]]


class ProgramRanges:
    """Opens the program's named ranges (``utils/profiling.scope``) for the
    block, as its own ``trace`` does, without writing a trace file."""

    def __init__(self, profiling_module):
        self.module = profiling_module

    def __enter__(self):
        self.module._ranges = True
        return self

    def __exit__(self, *exc):
        self.module._ranges = False
        return False


def profile(device: torch.device, host: bool = True):
    """A torch.profiler of the device's operations and, with ``host``, of
    the host's (operators and the program's ranges)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    activities = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return _profile(activities=activities)


def device_busy_s(prof) -> float:
    """Seconds of the device's kernels, copies and sets in a finished
    device-only profile (``profile(device, host=False)``: no named range is
    open), by the busy rule above, read from the profiler's raw events
    without building its per-operation tables, which takes minutes for a
    window of a host-bound loop."""
    from torch.autograd import DeviceType

    total_ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            total_ns += e.duration_ns()
    return total_ns / 1e9


def summarize(prof, wall_s: float) -> TraceSummary:
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    range_keys = {e.key for e in host}
    device = [e for e in rows if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)
              and e.key not in range_keys]
    out = TraceSummary(wall_s=wall_s,
                       busy_s=sum(e.self_device_time_total for e in device) / 1e6)
    for e in host:
        out.ranges[e.key] = (e.cpu_time_total, e.device_time_total, e.count)
    for e in device:
        out.kernels[e.key] = (e.self_device_time_total, e.count)
    out.idle_gaps = idle_gaps(prof.events(), range_keys)
    return out


def idle_gaps(events, range_keys, n: int = 10, look_back: int = 64) -> list:
    """The device's idle gaps, summed by the innermost host operation
    running at each gap's middle ("python" where no profiled operation
    was), the ``n`` largest sums."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            cpu.append((tr.start, tr.end, e.name))
        elif not getattr(e, "is_user_annotation", False) and e.name not in range_keys:
            dev.append((tr.start, tr.end))
    if len(dev) < 2:
        return []
    dev = np.array(sorted(dev), dtype=np.float64)
    ends = np.maximum.accumulate(dev[:, 1])
    gap_start, gap_end = ends[:-1], dev[1:, 0]
    keep = gap_end > gap_start
    gap_start, gap_end = gap_start[keep], gap_end[keep]
    if len(gap_start) == 0:
        return []
    mid = 0.5 * (gap_start + gap_end)
    cpu.sort()
    starts = np.array([c[0] for c in cpu], dtype=np.float64)
    stops = np.array([c[1] for c in cpu], dtype=np.float64)
    names = np.array([c[2] for c in cpu] + ["python"], dtype=object)
    at = np.searchsorted(starts, mid, side="right")  # events started by mid
    cand = at[:, None] - 1 - np.arange(look_back)[None, :]
    valid = cand >= 0
    safe = np.where(valid, cand, 0)
    covers = valid & (stops[safe] >= mid[:, None])
    # the latest-started covering event is the innermost one
    first = np.where(covers.any(1), covers.argmax(1), -1)
    pick = np.where(first >= 0, safe[np.arange(len(mid)), np.maximum(first, 0)], len(cpu))
    sums: dict = {}
    for name, gap in zip(names[pick], (gap_end - gap_start) / 1e6):
        sums[name] = sums.get(name, 0.0) + float(gap)
    top = sorted(sums.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[k[:120], v] for k, v in top]
