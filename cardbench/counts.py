"""The work of the planner's kernels, counted from the OCP's shapes, and the
card's published peaks: the yardstick of the roofline metrics.

``ip_iter_flops`` counts one interior-point iteration of the lane QP
kernel per problem from the row structure (+, -, *, / and negation count
1, a fused multiply-add 2; comparisons, min, max and |.| 0; the
fraction-to-boundary ratios left out, so it is a lower bound).
``single_flops`` counts one whole single-instance solve from its per-part
counts. The per-problem counts of a linearization (with its mirror pass)
and of a merit evaluation are data of each configuration file
(``counts``), counted by running the kernels' own per-problem code with a
counting scalar type. A share of the roofline is the least time the card
could take for the work, the larger of operations over the peak rate and
bytes over the memory rate, divided by the time the kernel took."""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, dense, at 700 W: FP64 on the tensor cores
#: (the larger of its two FP64 rates; 34 TFLOP/s outside them), FP32
#: outside the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float64": 8, "float32": 4}


def ip_iter_flops(row_meta, stage_mask, nx, nu) -> int:
    """Operations of one interior-point iteration of the lane QP kernel on
    one problem. ``row_meta`` tags each row ("box", col, sign) or ("h",
    slot); ``stage_mask`` is (T, m)."""
    mask = np.asarray(stage_mask) > 0
    T = mask.shape[0]
    nz = nx + nu
    on = mask.sum(axis=0)
    active = mask.any(axis=0)
    if not active.any():
        return 0
    box = np.array([meta[0] == "box" for meta in row_meta])
    p = nz
    per_row = np.where(box, 32 * T + 38 * on,
                       (2 * p * p + 7 * p + 25) * T + (4 * p + 34) * on) + 2
    factor = (nx * nx * (2 * nx - 1) + nx * nu * (2 * nx - 1)
              + nu * nu * 2 * nx + nu * nx * 2 * nx + nx * nx * 2 * nx
              + {1: 1, 2: 10, 3: 33}[nu]
              + nu * nx * 2 * nu
              + nx * nx * (2 * nu - 1) + 4 * nx * nx)
    solve_vec = (4 * nx * nx + 4 * nx * nu + 2 * nu * nu
                 + 2 * nx * nu + 2 * nx * nz)
    stages = ((T - 1) * (factor + nx * (1 + 2 * nz) + 2 * solve_vec) + nx
              + T * nz * (2 * nz + 3))
    return int(per_row[active].sum() + stages + 10)


def single_flops(n_sqp, n_qp_iter, counts: dict, T, nz, mirror=True,
                 track_best=True) -> int:
    """Operations of one single-instance solve of one problem: per SQP
    iteration a linearization, the mirror pass, the QP's own work and the
    step (2 T nz); every interior-point iteration; the merit of the start,
    of every iterate and of the returned one."""
    per_sqp = (counts["lin"] + counts["qp"] + 2 * T * nz
               + (counts["mirror"] if mirror else 0))
    n_merit = 1 + (1 + n_sqp if track_best else 0)
    return (n_sqp * per_sqp + n_sqp * n_qp_iter * counts["ip_iter"]
            + n_merit * counts["merit"])


def qp_words(T, nx, nu, m, mh) -> int:
    """Words of one problem's QP in the lane kernel's layout (H's upper
    triangle, g, A, B, c, the generic rows of D, e, r0) and of its step z."""
    nz = nx + nu
    return (T * nz * (nz + 1) // 2 + T * nz + (T - 1) * (nx * nx + nx * nu
            + nx) + T * max(mh, 1) * nz + T * m + nx + T * nz)


def least_seconds(flops, n_bytes, dtype):
    """(seconds, "operations" | "bytes") the card needs at least."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
