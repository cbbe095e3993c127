"""pcg_update_roofline: the fused PCG loop's direction update (one pass per
iteration, ``csrc/pcg_vector_update.cu``) on the structured grid: its least
time (``benchmarks/harness/work.pcg_update``) over its device time, summed
over the launches the profiler recorded, in percent of the published H100
peaks.  A solve's first update (the kernel's ``FIRST`` instance,
``cg_direction_update_kernel<T, true>``) reads no p and s and is charged its
own least work.  None where the kernel did not launch (a program without it,
a run on the CPU)."""

import re

from benchmarks.harness.work import least_seconds, pcg_update

KERNEL = "cg_direction_update_kernel"
# the FIRST template argument of the kernel's name
_FIRST = re.compile(KERNEL + r"<[^,<>]+, (true|false)>")


def read(ctx):
    if ctx.trace is None:
        return None
    least = device = 0.0
    for name, (us, launches) in ctx.trace.kernels.items():
        if KERNEL not in name or launches == 0:
            continue
        match = _FIRST.search(name)
        first = match is not None and match.group(1) == "true"
        least += launches * least_seconds(*pcg_update(ctx.box, first))
        device += us / 1e6
    if least == 0 or device <= 0:
        return None
    return 100.0 * least / device
