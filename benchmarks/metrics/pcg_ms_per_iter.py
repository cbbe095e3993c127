"""pcg_ms_per_iter: host wall time inside the program's ``pcg_solve``
range (solver/stepper.py), over the traced frames' PCG iterations."""

from benchmarks.harness.trace import PCG_RANGE


def read(ctx):
    if ctx.trace is None or PCG_RANGE not in ctx.trace.ranges:
        return None
    iterations = sum(t.pcg_iterations for t in ctx.telemetry)
    if iterations == 0:
        return None
    return ctx.trace.ranges[PCG_RANGE][0] / 1e3 / iterations
