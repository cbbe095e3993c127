"""K7_tet_roofline: K7's least time on the tet4 mesh (the element forces,
``benchmarks/harness/work.tet_element_forces``) over its mean device time
per launch, in percent of the published H100 peaks."""

from benchmarks.harness import roofline, work

WORK = work.tet_element_forces
KERNELS = ("element_forces_kernel<float, 4, 1>",)


def read(ctx):
    return roofline.share(ctx, WORK, KERNELS)
