"""stepper_device_ms_per_step: device time of the kernels launched inside
the program's ``newmark_predictor``, ``effective_rhs`` and
``newmark_update`` ranges (solver/stepper.py), per traced frame."""

from benchmarks.harness.trace import STEPPER_RANGES


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    rows = [ctx.trace.ranges[n] for n in STEPPER_RANGES if n in ctx.trace.ranges]
    device_us = sum(r[1] for r in rows)
    if not rows or device_us <= 0:
        return None
    return device_us / 1e3 / ctx.frames
