"""host_syncs_per_iter: the program's ``StepTelemetry.host_syncs`` (the
points where it blocked the host on the device, ``utils.profiling.
host_syncs``) summed over the traced frames, over their PCG iterations."""


def read(ctx):
    syncs = [getattr(t, "host_syncs", None) for t in ctx.telemetry]
    iterations = sum(t.pcg_iterations for t in ctx.telemetry)
    if not syncs or None in syncs or iterations == 0:
        return None
    return sum(syncs) / iterations
