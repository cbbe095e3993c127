"""pcg_update_roofline: the fused PCG loop's direction update (one pass per
iteration, ``csrc/pcg_vector_update.cu``) on the structured grid: its least
time over its device time, summed over the launches the profiler recorded,
in percent of the published H100 peaks.  A solve's first update (the
kernel's ``FIRST`` instance, ``cg_direction_update_kernel<T, true>``)
reads no p and s and is charged its own least work.  None where the kernel
did not launch (a program without it, a run on the CPU)."""

import re

from benchmarks.harness.work import least_seconds

KERNEL = "cg_direction_update_kernel"
# the FIRST template argument of the kernel's name
_FIRST = re.compile(KERNEL + r"<[^,<>]+, (true|false)>")


def pcg_update(box, first: bool = False) -> tuple:
    """Least work of one direction update on a grid of N nodes, in the
    convention of ``benchmarks/harness/work.py``: six f32 3-vectors read
    (x, r, p, s, u, w: 72 B) and four written (x, r, p, s: 48 B), the 1-byte
    mask per component (3 B): 123 B and 24 operations per node (the p and s
    recurrences and the x and r axpys, a product and a sum each).  A
    solve's first update (``first``) reads no p and s and computes no
    recurrence: 99 B and 12 operations per node."""
    n = box.node_count
    return (99 * n, 12 * n) if first else (123 * n, 24 * n)


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
