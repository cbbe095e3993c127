"""A kernel's share of its roofline from the traced window."""

from __future__ import annotations

from .work import least_seconds


def share(ctx, work, kernels):
    """100 * least seconds per launch / device seconds per launch, over the
    launches the profiler recorded of the kernels named ``kernels``; None
    where none ran."""
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.kernel_time(kernels)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * least_seconds(*work(ctx.box)) / (seconds / launches)
