"""s1_roofline.tick (kernels layer): the per cent of its roofline that the
single-instance kernel S1 (``sqp_single_kernel``) reaches over the window:
the whole solve's counted work per launch, the problem read and the result
written, against the published FP64 and HBM peaks."""

from cardbench.metrics_context import roofline_share, single_work

KERNEL = r"sqp_single_kernel"


def read(ctx):
    return roofline_share(ctx, KERNEL, single_work)
