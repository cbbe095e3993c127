"""K2_roofline: K2's least time (the fused preconditioned operator on the
structured grid, ``benchmarks/harness/work.pc_keff``) over its mean device
time per launch, in percent of the published H100 peaks."""

from benchmarks.harness import roofline, work

WORK = work.pc_keff
KERNELS = ("pc_keff_sweep_kernel",)


def read(ctx):
    return roofline.share(ctx, WORK, KERNELS)
