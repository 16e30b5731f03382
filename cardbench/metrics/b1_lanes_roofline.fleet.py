"""b1_lanes_roofline.fleet (kernels layer): the per cent of its roofline that
the lane QP kernel (B1's field entry, ``qp_ip_kernel``) reaches over the
window: its interior-point iterations counted from the OCP's rows, its
QP read and step written, against the published FP64 and HBM peaks."""

from cardbench.metrics_context import lane_qp_work, roofline_share

KERNEL = r"qp_ip_kernel"


def read(ctx):
    return roofline_share(ctx, KERNEL, lane_qp_work)
