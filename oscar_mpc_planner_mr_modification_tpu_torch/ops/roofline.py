"""The FP32 roof of the card (kernel B3) and the counts that bound the port's
kernels.

Counterpart of the JAX package's ``tools/bench_roofline.py::fma_kernel``:
:func:`fma_roof` runs ``csrc/fma_roof.cu`` for CUDA tensors (built with nvcc
for ``sm_90a`` at first use, loaded with ctypes) and
:func:`fma_roof_reference`, its plain PyTorch version, for CPU tensors.
Both take an f32 tensor of ``8 * S`` elements as 8 accumulator blocks of S
and run every element through ``FMA_STEPS`` chained steps
``y = y * FMA_A + FMA_B``; the kernel rounds once per step (``fmaf``), the
plain version twice; :func:`fma_roof_emulated` rounds as the kernel does.
``launches`` counts kernel launches.

:func:`ip_iter_flops` counts the operations of one iteration of the QP
kernels' interior-point code. :func:`bound_ms` is the least time the card
could take for a given work:
the larger of bytes over the memory rate and operations over the FP32 rate,
both the published H100 SXM figures at its 700 W limit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import qp_cuda

#: Number of kernel launches in this process (the plain version does not count).
launches = 0

FMA_ACC = 8  # independent accumulator blocks (the TPU kernel's N_ACC)
FMA_STEPS = 256  # chained steps per element (the TPU kernel's K_INNER)
FMA_A, FMA_B = 1.000000119, 1.1920929e-07  # rounded to f32 where used
FMA_THREADS = 256  # threads per block of csrc/fma_roof.cu

#: Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
#: cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: Algorithmic FLOPs of one bench fleet solve per problem (N=20, nz=7,
#: nx=5, m=22, schedule 1x3+1x5+2x8), copied from the JAX package's
#: ``bench.py``: XLA cost analysis of the JAX ``backend="xla"`` fleet solve
#: on the CPU, which counts each scan body once (so the IP iterations of a
#: phase count as one). Comparable with the JAX bench's achieved FLOP/s.
ALGO_FLOPS_PER_PROBLEM = 2.7563e6

#: FLOPs of one interior-point iteration of the QP kernels per problem at
#: the bench QP (T=21, nx=5, nu=2; 8 dense generic rows and 14 box rows,
#: 430 of the 462 (stage, row) entries unmasked): :func:`ip_iter_flops` of
#: the bench OCP's row structure (tests/test_torch_roofline.py recomputes it).
IP_ITER_FLOPS = 90662

#: Algorithmic FLOPs of one linearization per problem at the bench shape
#: (N=20, the bench OCP): the QP fields and the merit terms, XLA cost
#: analysis of the JAX ``ops/linearize.py::make_lane_linearizer`` plus
#: ``make_lane_merit`` on the CPU (1.0230e6 + 1.95e4; tests/test_torch_roofline.py
#: repeats it).
LIN_FLOPS = 1.0425e6


def fma_flops(n: int) -> float:
    """FLOPs of one roof launch on n elements (one FMA = 2)."""
    return 2.0 * FMA_STEPS * n


def ip_iter_flops(row_meta, stage_mask, nx: int, nu: int) -> int:
    """Floating-point operations of one iteration of
    ``csrc/qp_ip.cuh::ip_solve_problem`` on one problem, counted from its
    loops: +, -, *, / and negation count 1 (an FMA 2); comparisons, min, max
    and |.| are not counted. ``row_meta`` tags each row as ``qp_cuda`` does
    (``("box", ...)`` rows cost O(1) per stage, generic rows are dense over
    the nz columns); ``stage_mask`` is the (T, m) mask. Left out: the
    fraction-to-boundary ratios, a negation and a division that run only
    where a step shrinks a slack or a multiplier (at most 4 ratios per
    unmasked entry), so the count is a lower bound of what the data asks.
    tests/test_torch_roofline.py holds it against the header compiled for
    the host with a counting scalar type (``csrc/qp_ip_count.cpp``)."""
    mask = np.asarray(stage_mask) > 0
    T = mask.shape[0]
    nz = nx + nu
    on = mask.sum(axis=0)
    active = mask.any(axis=0)
    if not active.any():
        return 0  # one Riccati solve, no iterations
    box = np.array([meta[0] == "box" for meta in row_meta])
    p = nz  # generic rows contract every (D column, z column) pair
    # per active row: every stage, then each unmasked stage, then once
    per_row = np.where(box, 32 * T + 38 * on,
                       (2 * p * p + 7 * p + 25) * T + (4 * p + 34) * on) + 2
    factor = (nx * nx * (2 * nx - 1) + nx * nu * (2 * nx - 1)
              + nu * nu * 2 * nx + nu * nx * 2 * nx + nx * nx * 2 * nx
              + {1: 1, 2: 10, 3: 33}[nu]  # closed-form inverse of Quu
              + nu * nx * 2 * nu
              + nx * nx * (2 * nu - 1) + 4 * nx * nx)
    solve_vec = (4 * nx * nx + 4 * nx * nu + 2 * nu * nu  # backward sweep
                 + 2 * nx * nu + 2 * nx * nz)  # forward rollout
    stages = ((T - 1) * (factor + nx * (1 + 2 * nz) + 2 * solve_vec) + nx
              + T * nz * (2 * nz + 3))  # H z + g, NaN sum, z update
    return int(per_row[active].sum() + stages + 10)


def ip_flops(n_problems: int, n_iters: int) -> float:
    """Algorithmic FLOPs of ``n_iters`` interior-point iterations on
    ``n_problems`` bench-shape QPs."""
    return IP_ITER_FLOPS * n_iters * n_problems


def sqp_flops(n_problems: int, schedule) -> float:
    """Algorithmic FLOPs of one fleet solve on the schedule: one
    linearization per SQP iteration and every interior-point iteration.
    ``ALGO_FLOPS_PER_PROBLEM`` (the JAX bench's convention) counts each
    phase's IP loop once and comes out about 2.3x lower."""
    n_lin = sum(n_sqp for n_sqp, _ in schedule)
    n_ip = sum(n_sqp * n_qp for n_sqp, n_qp in schedule)
    return (LIN_FLOPS * n_lin + IP_ITER_FLOPS * n_ip) * n_problems


def qp_bytes(T, nx, nu, m, mh, n_problems, itemsize, lam_in=False,
             lam_out=False) -> int:
    """Bytes a QP solve must move in the kernel's layout: H's upper
    triangle, g, A, B, c, the generic rows of D, e and r0 read once, z (and
    the multipliers) written once."""
    nz = nx + nu
    fields = (T * nz * (nz + 1) // 2 + T * nz + (T - 1) * (nx * nx + nx * nu
              + nx) + T * max(mh, 1) * nz + T * m + nx + T * nz
              + T * m * (int(lam_in) + int(lam_out)))
    return fields * n_problems * itemsize


def bound_ms(flops: float, n_bytes: float):
    """``(ms, "operations" | "bytes")``: the least time of work that does
    ``flops`` FP32 operations and moves ``n_bytes`` (each input read once,
    each output written once), and which of the two bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_bytes(*tensors) -> int:
    """Bytes held by the given tensors."""
    return sum(t.numel() * t.element_size() for t in tensors)


def fma_roof_reference(x):
    """Plain PyTorch version of the roof kernel: the same recurrence,
    rounded after the product and after the sum."""
    a = torch.tensor(FMA_A, dtype=x.dtype, device=x.device)
    b = torch.tensor(FMA_B, dtype=x.dtype, device=x.device)
    y = x
    for _ in range(FMA_STEPS):
        y = y * a + b
    return y


def fma_roof_emulated(x):
    """The kernel's recurrence rounded as ``fmaf`` rounds it, once per step:
    each step in f64, then rounded to f32. The product of two f32 values is
    exact in f64, and so is adding b = 2^-23 while 2^-29 <= |y| < 2^29, so
    there the result is the kernel's bit for bit."""
    a, b = (float(torch.tensor(v, dtype=torch.float32)) for v in (FMA_A, FMA_B))
    y = x.float()
    for _ in range(FMA_STEPS):
        y = (y.double() * a + b).float()
    return y


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(qp_cuda.build("fma_roof").path)
    lib.fma_roof_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p]
    lib.fma_roof_f32.restype = ctypes.c_int
    lib.fma_roof_steps.restype = ctypes.c_int
    if lib.fma_roof_steps() != FMA_STEPS:
        raise RuntimeError("csrc/fma_roof.cu and FMA_STEPS disagree")
    return lib


def fma_roof(x):
    """The chained-FMA recurrence on every element of the f32 tensor x,
    whose element count is a multiple of ``FMA_ACC * FMA_THREADS``. CUDA
    tensors go through the kernel, CPU tensors through
    :func:`fma_roof_reference`."""
    global launches
    if x.dtype != torch.float32:
        raise TypeError(f"fma_roof takes float32, not {x.dtype}")
    if x.numel() == 0 or x.numel() % (FMA_ACC * FMA_THREADS):
        raise ValueError(f"fma_roof needs a multiple of {FMA_ACC * FMA_THREADS} "
                         f"elements, got {x.numel()}")
    if x.device.type == "cpu":
        return fma_roof_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"fma_roof runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("fma_roof takes a contiguous tensor")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().fma_roof_f32(
            x.data_ptr(), y.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma_roof kernel launch failed with error {err}")
    launches += 1
    return y
