"""G1_roofline: G1's least time on the tet4 mesh (the gather of the force
rows into K_eff x, ``benchmarks/harness/work.assemble_tet``) over its mean
device time per launch, in percent of the published H100 peaks."""

from benchmarks.harness import roofline, work

WORK = work.assemble_tet
KERNELS = ("assemble_csr_kernel<float>",)


def read(ctx):
    return roofline.share(ctx, WORK, KERNELS)
