"""device_idle_share: 1 - (device time of kernels, copies and sets) /
(traced wall time), in percent; the busy time is the program's own rule
(utils/profiling.summary)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.wall_s)
