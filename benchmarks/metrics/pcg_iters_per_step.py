"""pcg_iters_per_step: the program's ``StepTelemetry.pcg_iterations``
summed over the traced frames, over the frames."""


def read(ctx):
    if not ctx.telemetry:
        return None
    return sum(t.pcg_iterations for t in ctx.telemetry) / len(ctx.telemetry)
