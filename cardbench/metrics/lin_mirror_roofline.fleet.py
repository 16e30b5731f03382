"""lin_mirror_roofline.fleet (kernels layer): the per cent of its roofline that
the mirror linearize entry reaches over the window (either design: the
block kernel, or the warp kernel's mirror instantiation): the
configuration's counted linearization with its mirror pass and merit
terms, the parameters and iterate read and the QP fields written."""

from cardbench.metrics_context import lane_linearize_work, roofline_share

KERNEL = r"mirror_block_kernel|sqp_fused_linearize_kernel<.*true>"


def read(ctx):
    return roofline_share(ctx, KERNEL, lane_linearize_work)
