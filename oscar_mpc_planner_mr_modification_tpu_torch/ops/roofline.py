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
kernels' interior-point code; ``LIN_FLOPS`` and ``MERIT_FLOPS`` are the
fused kernel's own counts of a linearization and a merit evaluation, at the
fleet bench's OCP; the ``TICK_``, ``ROLLOUT_``, ``GATE_`` and ``GOAL_``
constants are the same three counts at the planner tick's OCP, the
contouring evaluator's, BASELINE config 2's f32 gate's and BASELINE config
1's goal OCP, and the ``CCMPC_``, ``CCMPC6_`` and ``SHMPC_`` constants at the
OCPs of BASELINE configs 3 and 5. :func:`bound_ms` is the least time the card could take
for a given work:
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

#: Operations of one linearization (every QP field) per problem at the bench
#: OCP (N=20): ``csrc/tmpc_ocp.cuh::linearize_warp`` run on the host by
#: ``csrc/qp_ip_count.cpp`` with a counting scalar type (each sqrt, exp,
#: sin, cos, atan2 and fmod counts 1; 1627 of them), the same on every
#: problem of the bench fleet. XLA's count of the JAX lane linearizer is
#: about 6x larger (it differentiates by jacfwd over jacrev, the kernel by
#: forward-mode jets with a packed Hessian triangle).
#: tests/test_torch_roofline.py recomputes it.
LIN_FLOPS = 162321
#: Operations of one evaluation of the merit terms (cost, dynamics defects)
#: per problem at the bench OCP, counted the same way (``merit_warp``).
MERIT_FLOPS = 27822

#: The three counts at the planner tick's OCP (``bench.py::_e2e_tick``:
#: ``default_settings(N=20, max_obstacles=3)``, npar=88; 6 dense generic
#: rows and 14 box rows), from the same hand count and counting build; equal
#: on every planner of the tick's fleet. tests/test_torch_roofline.py
#: recomputes them.
TICK_IP_ITER_FLOPS = 80954
TICK_LIN_FLOPS = 157881
TICK_MERIT_FLOPS = 27822

#: The three counts at the contouring evaluator's OCP
#: (``parallel/rollout.py::make_contouring_rollout`` at N=20, 3 obstacles,
#: npar=76; 3 ellipsoid rows and 14 box rows), which B2 runs there; the
#: same hand count and counting build, equal on every episode.
ROLLOUT_IP_ITER_FLOPS = 66392
ROLLOUT_LIN_FLOPS = 144435
ROLLOUT_MERIT_FLOPS = 27675

#: The three counts at the BASELINE f32 gate's OCP
#: (``factory.configuration_basic`` at N=15, 2 obstacles, npar=69; 2
#: ellipsoid rows and 14 box rows), which B1 and B2 run in
#: ``chip_smoke.py``'s gate phase.
GATE_IP_ITER_FLOPS = 46298
GATE_LIN_FLOPS = 106665
GATE_MERIT_FLOPS = 21040

#: The three counts at the goal OCP of BASELINE config 1
#: (``parallel/rollout.py::_goal_ellipsoid_ocp`` at N=20, 3 obstacles,
#: npar=28 on ``SecondOrderUnicycleModel``; 3 ellipsoid rows and 12 box
#: rows), the same hand count and counting build. One OCP serves its f32
#: gate, the goal evaluator and the multi-robot evaluator at 4 robots (3
#: peers), on every problem. The T-MPC evaluator runs the fleet bench's OCP
#: (4 obstacles, npar=98) and so its counts are ``IP_ITER_FLOPS``,
#: ``LIN_FLOPS`` and ``MERIT_FLOPS``.
GOAL_IP_ITER_FLOPS = 49731
GOAL_LIN_FLOPS = 65913
GOAL_MERIT_FLOPS = 4692

#: The three counts at the CC-MPC OCP (BASELINE config 3's formulation:
#: MPCBase on a, w and v, contouring and Gaussian chance constraints on
#: ``ContouringSecondOrderUnicycleModel``) at N=20 with 3 obstacles (npar=73;
#: 3 Gaussian rows and 14 box rows), which B2 and B1 run on the CC-MPC fleet
#: of ``tools/bench_matrix.py`` and B2 in the CC-MPC evaluator
#: (``make_contouring_rollout(constraints="gaussian")``); its IP iteration
#: has the contouring evaluator's row structure. The same hand count and
#: counting build, equal on every problem.
CCMPC_IP_ITER_FLOPS = 66392
CCMPC_LIN_FLOPS = 156015
CCMPC_MERIT_FLOPS = 27675
#: The same at BASELINE config 3's own size, 6 Gaussian obstacles (npar=91;
#: 6 generic rows and 14 box rows, the tick OCP's structure).
CCMPC6_IP_ITER_FLOPS = 80954
CCMPC6_LIN_FLOPS = 178935
CCMPC6_MERIT_FLOPS = 27675
#: The three counts at the SH-MPC OCP (``factory.configuration_safe_horizon``
#: at N=20: nx=6, npar=127; 24 scenario rows and 16 box rows), which B2 and
#: B1 (at (6, 2)) run on the SH-MPC fleet of ``tools/bench_matrix.py`` and in
#: the SH-MPC planner tick.
SHMPC_IP_ITER_FLOPS = 206840
SHMPC_LIN_FLOPS = 221205
SHMPC_MERIT_FLOPS = 28560
#: The three counts at the multi-robot tick's OCP
#: (``factory.configuration_goal_tmpc`` at ``default_settings()``: N=30, 4
#: obstacles, goal, consistency, 4 topology halfspaces and 4 ellipsoids on
#: ``SecondOrderUnicycleModel``), which B2 runs once per robot tick under
#: ``multirobot.driver.RobotAgent``.
MRTICK_IP_ITER_FLOPS = 104536
MRTICK_LIN_FLOPS = 119901
MRTICK_MERIT_FLOPS = 7239
#: The three counts at the T-MPC fleet OCP with the dynamic velocity
#: reference (``tools/bench_matrix.py::build_dynvref``, N=20, npar 118):
#: the bench OCP's rows, and a linearization that also evaluates the
#: velocity spline.
VREF_IP_ITER_FLOPS = 90662
VREF_LIN_FLOPS = 170595
VREF_MERIT_FLOPS = 32862
#: The three counts at the LMPCC OCP (``factory.configuration_lmpcc`` at
#: N=20, 3 obstacles: goal and ellipsoids on the contouring unicycle;
#: ``tools/bench_matrix.py::build_lmpcc``).
LMPCC_IP_ITER_FLOPS = 66392
LMPCC_LIN_FLOPS = 84502
LMPCC_MERIT_FLOPS = 5514
#: The three counts at the bicycle OCP (``factory.configuration_bicycle``
#: at ``default_settings()``: N=30, nx=6, nu=3, 4 ellipsoids and 18 box
#: rows; ``tools/bench_matrix.py::build_bicycle``), which B2 and B1 (at
#: (6, 3)) run on the bicycle fleet.
BICYCLE_IP_ITER_FLOPS = 163789
BICYCLE_LIN_FLOPS = 357436
BICYCLE_MERIT_FLOPS = 44821
#: The same at its curvature-aware variant (the same rows; the progress
#: update adds a path evaluation with its second derivatives to every
#: dynamics step).
BICYCLE_CA_IP_ITER_FLOPS = 163789
BICYCLE_CA_LIN_FLOPS = 399616
BICYCLE_CA_MERIT_FLOPS = 83551
#: The bicycle OCP with the two road-width rows of
#: ``ContouringConstraintModule`` (``build_bicycle(road_width=True)``).
ROAD_IP_ITER_FLOPS = 183493
ROAD_LIN_FLOPS = 444676
ROAD_MERIT_FLOPS = 44821
#: The CA-MPC OCP (``tools/bench_matrix.py::build_ca_unicycle``: the
#: curvature-aware unicycle with MPCBase, the CA contouring cost and 3
#: ellipsoids at N=20).
CA_IP_ITER_FLOPS = 66392
CA_LIN_FLOPS = 199560
CA_MERIT_FLOPS = 59060
#: The decomp OCP (``tools/bench_matrix.py::build_decomp``:
#: ``configuration_no_obstacles`` plus 12 decomp rows at N=20, m=26).
DECOMP_IP_ITER_FLOPS = 110078
DECOMP_LIN_FLOPS = 153735
DECOMP_MERIT_FLOPS = 27675


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


def ip_flops(n_problems: int, n_iters: int, ip_iter=IP_ITER_FLOPS) -> float:
    """Algorithmic FLOPs of ``n_iters`` interior-point iterations on
    ``n_problems`` QPs of ``ip_iter`` operations per iteration (by default
    the bench's)."""
    return ip_iter * n_iters * n_problems


def sqp_flops(n_problems: int, schedule, lin=LIN_FLOPS, merit=MERIT_FLOPS,
              ip_iter=IP_ITER_FLOPS) -> float:
    """Operations of one fused fleet solve on the schedule, as the bench
    runs it (``track_best=False``): one linearization per SQP iteration,
    every interior-point iteration, and the merit terms of the returned
    iterate, each per problem as the OCP's counts give it (by default the
    fleet bench's). ``ALGO_FLOPS_PER_PROBLEM`` (the JAX bench's convention:
    XLA's counts, each phase's IP loop once) is a different count that
    happens to land within 5% of this one."""
    n_lin = sum(n_sqp for n_sqp, _ in schedule)
    n_ip = sum(n_sqp * n_qp for n_sqp, n_qp in schedule)
    return (lin * n_lin + merit + ip_iter * n_ip) * n_problems


def lin_flops(n_problems: int) -> float:
    """Operations of one launch of the linearize entry: the QP fields and
    the merit terms of every problem."""
    return (LIN_FLOPS + MERIT_FLOPS) * n_problems


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
