#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Builds the five kernel libraries from the checkout, in parallel, and prints
each ptxas report: the interior-point QP kernel (csrc/qp_ip.cu, with its
cold, duals/warm and field-layout entries), the fused whole-SQP kernel
(csrc/sqp_fused.cu, with its linearize entry), the FP32 roof kernel
(csrc/fma_roof.cu) and the single-instance SQP kernel S1
(csrc/sqp_single.cu; its launch plans at the golden, basic, demo and
bicycle OCPs) and the mirror linearize entry (csrc/sqp_linearize_mirror.cu). B1 and B2 run one warp per problem with its state in
shared memory: for every entry it prints the launch plan at the bench shape
and at the goal, CC-MPC and SH-MPC OCPs of BASELINE configs 1, 3 and 5 and at the bicycle OCPs (warps
per block, dynamic shared memory per block, problems resident per SM,
registers and local memory per thread). Holds each against its plain PyTorch version: the QP
kernel on the bench QPs (cold; cold with duals out, then warm from them on
the re-linearized QPs; on the linearize entry's buffer), the fused kernel's
in-kernel linearization against torch.func, its whole solve at f64, and the
roof kernel. Solves the contouring_2obs golden at f64. Drives the T-MPC++
fleet step (B=512 plans x 9 planners, N=20, f32) through each of the port's
paths, each with the launch counts set to 0 just before it and read just
after: the main path ``backend="fused"`` (one fused launch per step), the
per-iteration path ``backend="pallas"`` (one QP launch per SQP iteration),
the dual-warm per-iteration path (``n_qp_iter_warm`` 8 and 6 against cold,
at n_sqp=10, n_qp_iter=15) and the lane path ``backend="lanes"`` (one
linearize and one QP launch per SQP iteration); holds them against each
other and against the plain paths. Times the steps and kernels against their
plain versions with CUDA events, profiles the fused and lane steps, measures
the FP32 roof and the matmul ceilings (tools/bench_roofline.py) and the
achieved FLOP/s against them. Then drives the single-robot planner tick of
bench.py::_e2e_tick (Planner -> TMPCOptimizer -> one B2 launch per tick; 5
planners, N=20, f32, 12 crossing pedestrians on a 65 m path, simulated
clock): 124 serial and 124 pipelined ticks on the scene of bench.py's
serial loop, and 124 pipelined on the timing of its pipelined loop, each
run with the launch counts set to 0 just before it; checks one B2 launch
and no other per tick, the fused backend, the C++ guidance PRM and
H-signature, success, progress and (on the first two) clearance to the
pedestrians; holds B2 at the tick's shape against its plain version and
times the ticks, the host share, B2 and the PRM, and profiles three pipelined
ticks. Then the single-instance solve (S1) and BASELINE config 2
(contouring with ellipsoidal obstacles), each run with the launch counts
set to 0 just before it: (a) the contouring_2obs golden through
make_sqp_solver at f64 (one S1 launch and no other kernel; atol 1e-6, rtol
1e-8; ms and device ops per solve; S1 against its plain version on the
card within B2's f64 gate); BASELINE's f32 gate (max |U32 - U64| <= 1e-3
against tests/golden/validate_contouring_U64.npy) through B1, through B2
and through S1 (backend="xla"), with B1 at the gate's QPs against its
plain version; (c) the
configuration_basic planner tick at default_settings (N=30, f64; Planner
-> Solver.solve, one S1 launch per tick) on the card, its first tick
against the same solve on the CPU, the tick and solve medians beside the
44 ms budget, S1 at the tick's inputs against plain; (c2) the T-MPC++
fleet step through backend="xla" at 8 x 9 = 72 problems (one S1 launch,
plans agreeing with the fused step's, S1 at f64 against plain on every
problem); and the
contouring evaluator of tools/bench_rollout.py (4096 episodes, 60 ticks,
f32, one B2 launch per tick, nothing read back between ticks, f64 kernel
against plain on a short rollout, B2 on its first tick against plain at
f64, every problem, and at f32). Then BASELINE config 1 (goal tracking on
SecondOrderUnicycleModel, nx=4, with 3 ellipsoids) and the other
evaluators, each run with the launch counts set to 0 just before it:
(e) its f32 gate against tests/golden/validate_goal_U64.npy through B1's
(4, 2) instance, through B2's goal model and through S1, B1 at the gate's
QPs against
its plain version and B2 on them at f64 (the contouring gate runs the same
B2 check); (f) the goal evaluator (4096 episodes), (g) the multi-robot
evaluator (1024 episodes x 4 robots, comm="always", then "triggered" with
its comm_rate) and (h) the T-MPC evaluator (819 episodes x 5 planners, 4
obstacles), all at tools/bench_rollout.py's shape (N=20, 60 ticks, f32),
with the contouring evaluator's checks: one B2 launch per tick and nothing
else, no copy between ticks (profiled once), success >= 0.9, f64 kernel =
plain on a short rollout, B2 on the first tick against plain at f64 and
by per-problem medians at f32, episodes/s. Then BASELINE configs 3
(CC-MPC) and 5 (SH-MPC), each run with the launch counts set to 0 before
it: tools/bench_matrix.py's five fleets (B=512, N=20, f32) through B2; (a)
the CC-MPC fleet through B2 (the Gaussian row) and B1 at (5, 2), and at
BASELINE config 3's own size (256 instances, 6 Gaussian obstacles) through
B2, each against its plain version (B2 at f64 every problem within 1e-6 with
the same success mask, at f32 by medians; B1 at f64 within 1e-8 (1 +
max|ref|)); (b) the CC-MPC evaluator (4096 episodes, 60 ticks, risk 0.05,
sigma 0.05 sqrt(k + 1)) with the evaluators' checks, and its larger obstacle
margins than the ellipsoid evaluator's on the same scenes and on the JAX
test's scene; (c) the SH-MPC fleet (m=40, the slack model) through B2 and
B1 at (6, 2), held as in (a); (d) the SH-MPC planner tick
(configuration_safe_horizon, build_planner, 4 scenario solvers, 60 serial
ticks under Gershgorin with one B2 launch each, then ticks under "mirror"
on the lane path, (m3) below): success, no contact with the
pedestrians' mean positions, ms per tick, support and certificate. Then
the multi-robot coordination path and the rest of 4a, each run with the
launch counts set to 0 before it: (i) three goal_tmpc RobotAgents
(systems.make_system_planner("jackalsimulator", "goal_tmpc"): N=30, 5
planners, f32) on an intersection with a crossing pedestrian under
MultiRobotDriver.run (60 cycles) and run_desynchronized: one B2 launch per
planning tick and nothing else, no collision, the JAX test's progress, a
communication rate in (0, 0.95), trigger reasons, ms per robot tick, B2 at
the tick's shape (P=5, T=31) against its plain version; (j) the dynamic
velocity reference: B2's in-kernel linearization against torch.func at f64,
the dyn-vref fleet (512 problems) through B2 against its plain version, and
60 planner ticks on a path whose reference velocity falls, tracked more
closely over the last 20 ticks than over the first 20; (k) the eight
configurations of the JAX configuration sweep that the port has, 3 ticks
each at N=8 (B2 or the single-instance solve on S1), the LMPCC fleet (512
problems) through B2 against its plain version, and one
LocalPlannerInterface cycle (one S1 launch). Then ROADMAP item 4d, each fleet and tick run
with the launch counts set to 0 before it: (l) configuration_bicycle and
its curvature-aware variant (N=30, nx=6, nu=3, m=22) as 512-problem fleets
through B2 (the bicycle models) and through B1's (6, 3) instance, each
against its plain version, their launch plans at T=31, nz=9, and the
bicycle_contouring golden through make_sqp_solver at f64 (one S1
launch); (m) the
curvature-aware unicycle: B2's in-kernel linearization (the progress
update, the CA contouring cost) against torch.func at f64 on curved and
exactly straight paths with no NaN (the CA bicycle's too), and its fleet
through B2 against plain; (n) the decomposition's C++ backend, the decomp
fleet (12 halfspace rows) through B2 against plain, 3 ticks of JAX's
corridor scene through LocalPlannerInterface.set_costmap /
compute_velocity_commands (JAX's assertions; the single-instance solve,
one S1 launch per tick, timed, not gated) and the road-width bicycle fleet through B2 against
plain. Then (o) the sharded fleet step of parallel/mesh.py, each run with
the launch counts set to 0 before it: (o1) a 1x1 grid on an NCCL group of
one rank at the bench fleet (512 x 9, N=20, f32): "auto" resolved to
"fused", the champions gathered on the card, one B2 launch per step and no
other kernel, the unsharded fused step's winners (index equal, cost and z
within 1e-6 relative; whether bitwise equal is printed), both steps timed
by CUDA events in turns (the difference is the mesh layer's cost), B2
alone, the step through B2's plain twin, and at f64 (B=64) kernel against
plain; (o2) a 2x2 grid of four spawned processes on this card in a gloo
group with host staging, the fleet padded to P=10 with a disabled planner:
one B2 launch of 1280 problems per rank, the unsharded step's winners, the
gathered elements against the champion payload, per-rank ms (not gated);
(o3) the port's dryrun_multichip(4). The spawned processes only load the
libraries this process built. (o4) The host layers: the terminal
dashboard and web snapshot of the multi-robot run's MetricsLog, and
Planner.visualize and SceneRecorder.capture on the tick phase's planner.
Then (p) the repository's runnable entry points on the port, in this
process on the kernels built above: tools/bench.py (bench.py's five phases
and JSON line at 512 x 9, N=20, f32, "fused": the skeleton first, every
key, no -1 but vs_baseline, one B2 launch per fleet step, the fleet step
within 15% of B2's time above, mfu_chip below 1.05; B2 at its 72-problem
solve and at its device-resident rollout's tick against plain),
tools/exp_schedule_hw.py, tools/profile_e2e_tick.py in both modes,
tools/validate.py (both f32 gates through B1, its f64 cross-checks one S1
launch each), the four demos of examples/ (one B2 launch per planning
tick; the fleet-process demo's three spawned robots, the JAX demo's, one
S1 launch per planning solve, and S1 at their shape against plain) and
tools/kernel_check.py (every B1 instance, B2 model and h-row kind against
plain at f64).
The default regularization, "mirror", on the lane path (each run with the
launch counts set to 0 before it): (m1) after the lane step, the mirror
linearize entry (csrc/sqp_linearize_mirror.cu) against its plain version
(torch.func and eigh) at f64 on the bench fleet (4608 problems, T=21) and
the SH-MPC (nz=8) and bicycle (nz=9) fleets of 512, every field within
LIN_F64_RTOL / LIN_F64_ATOL, a NaN cost weight at one stage giving that
stage's H block all NaN and changing nothing else, timed beside the
Gershgorin linearize entry on the same inputs; (m2) after the tick, the
T-MPC++ tick with the planner built from the settings (sqp_config=None:
10 x 18 under "mirror"): the "lanes" backend, per tick 10 mirror linearize,
10 B1 field and 1 merit launch and nothing else, success, no contact,
median, p99 and spikes against 44 ms, the same tick through "pallas"
(torch.func and eigh) beside it, the two backends' winners at f64 on one
tick's problems, and B1's field entry at the tick's shape against plain;
(m3) in (d), the SH-MPC tick under "mirror" on the lane path the same way,
against its Gershgorin ticks. B2's solve kernels keep the registers and
stack of the parent's build (B2_PTXAS) and its time at the bench shape
(B2_BENCH_MS).
Any failed phase raises, so the script exits non-zero and prints no result. The last line is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
each with its bound. Needs one CUDA device; without one it exits with code 2.
"""

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (  # noqa: E402
    BENCH_SCHEDULE, FUSED_F64_GATE, GATE_B, GATE_CFG, GATE_FLAVOURS, GATE_TOL,
    LIN_F64_ATOL, LIN_F64_RTOL, QP_F64_GATE, SimClock, TickScene, basic_ocp,
    bench_config, bench_fleet, card_line, cuda_time_ms, gate_inputs, goal_ocp,
    launch_counts, ptxas_entries, tick_scene)

B_MAIN, N_MAIN, N_PATHS = 512, 20, 8
#: B2's fused solve at the bench shape, f32, over the runs of its PERF.md
#: row (ms), which this PR's mirror variant must not move.
B2_BENCH_MS = (16.77, 17.31)
#: B2's solve kernels as ptxas reported them for the sources before the
#: mirror variant (sqp_fused.cu without it, built on an H100 beside the
#: sources with it): "dtype model" -> (registers, cumulative stack
#: bytes).
B2_PTXAS = {
    "d ContouringUnicycle": (255, 1488), "d Unicycle": (255, 912),
    "d ContouringUnicycleSlack": (255, 1840), "d Bicycle": (255, 2520),
    "d BicycleCA": (255, 2320), "d ContouringUnicycleCA": (255, 1448),
    "f ContouringUnicycle": (255, 480), "f Unicycle": (168, 560),
    "f ContouringUnicycleSlack": (255, 656), "f Bicycle": (255, 904),
    "f BicycleCA": (255, 816), "f ContouringUnicycleCA": (255, 432)}
T0 = time.perf_counter()
#: B3's kernel rounds once per step (fmaf), its plain version twice: over
#: 256 steps the two may part by up to 3 roundings of 2^-24 per step.
FMA_RTOL = 3 * 256 * 2.0 ** -24


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def bench_qps(batch, dtype, device):
    """The bench fleet's machinery and its linearization point: P (stage N
    repeating N-1), x0 and Z, flat over plans x planners."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _f32_safe, _make_machinery)

    ocp, fleet = bench_fleet(batch, dtype, device)
    mach = _make_machinery(ocp, _f32_safe(bench_config(), dtype), dtype,
                           device)
    P, x0, Z = flat_fleet(fleet)
    return mach, fleet_P(P), x0, Z


def initial_qp(batch, dtype, device):
    """The bench fleet's QP batch, linearized at its initial iterate."""
    mach, P, x0, Z = bench_qps(batch, dtype, device)
    return mach.build_qp(Z, P, x0), mach


def qp_args(qp, mach):
    return (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask, qp.r0)


def compare(qp, mach, n_iters, cfg):
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda

    kw = dict(nu=mach.nu, n_iters=n_iters, mu_min=cfg.mu_min, w_max=cfg.w_max,
              row_meta=mach.row_meta)
    dz_k = qp_cuda.solve_qp_batched(*qp_args(qp, mach), **kw)
    dz_p = qp_cuda.ip_solve_reference(*qp_args(qp, mach), **kw)
    torch.cuda.synchronize()
    diff = (dz_k - dz_p).abs()
    per_problem = diff.amax(dim=(1, 2)) / (1.0 + dz_p.abs().amax(dim=(1, 2)))
    return dz_k, dz_p, diff, per_problem


@contextlib.contextmanager
def plain_fused_solver(fleet_solve):
    """Route a fused fleet solver through its plain version."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused

    kernel = sqp_fused._solve_kernel
    sqp_fused._solve_kernel = (
        lambda tables, rows, config, consts, P, xinit, Z:
        sqp_fused.fused_fleet_reference(fleet_solve.machinery, config, P,
                                        xinit, Z))
    try:
        yield
    finally:
        sqp_fused._solve_kernel = kernel


def flat_fleet(args):
    """Fleet step inputs (B, P, ...) -> fleet solve inputs (B*P, ...)."""
    params, xinit, z_init, _ = args
    B, P = params.shape[:2]
    return (params.reshape(B * P, *params.shape[2:]),
            xinit.repeat_interleave(P, dim=0),
            z_init.reshape(B * P, *z_init.shape[2:]))


def fleet_P(params):
    """(B*P, N, npar) -> (B*P, N+1, npar), stage N repeating N-1."""
    return torch.cat([params, params[:, -1:]], dim=1)


def profile_step(step, args):
    """Device kernels, device busy ms (union of device intervals) and wall ms
    of one step under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy / 1e3, wall


@contextlib.contextmanager
def plain_qp_solver():
    """Route the SQP engine's QP solves through the plain version."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda

    kernel = qp_cuda.solve_qp_batched
    qp_cuda.solve_qp_batched = qp_cuda.ip_solve_reference
    try:
        yield
    finally:
        qp_cuda.solve_qp_batched = kernel


def log_launch_plans(dev):
    """Every B1 and B2 entry's launch plan at the bench shape ((nx, nu) =
    (5, 2)), at BASELINE config 1's goal OCP ((4, 2), N=20, 3 obstacles),
    at config 3's CC-MPC OCP ((5, 2), 3 Gaussian rows), at config 5's
    SH-MPC OCP ((6, 2), 24 scenario rows, m=40) and at the multi-robot
    tick's goal-T-MPC OCP ((4, 2), T=31, 8 generic rows), f32 and f64."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_goal_tmpc)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    bench_ocp, _ = bench_fleet(1, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    for ocp in (bench_ocp, goal_ocp(),
                bench_matrix.build_ccmpc(N_MAIN, 1, rng)[0],
                bench_matrix.build_shmpc(N_MAIN, 1, rng)[0],
                build_ocp(*configuration_goal_tmpc(default_settings()),
                          default_settings())):
        solve = make_fleet_sqp_solver(ocp, bench_config(),
                                      dtype=torch.float32, device="cpu",
                                      backend="fused")
        log_plans(dev, ocp, solve.tables)
    log_single_plans(dev)


def log_single_plans(dev):
    """S1's launch plan, f32 and f64, at the contouring_2obs golden (N=15),
    at BASELINE config 2's planner OCP (N=30, 4 obstacles), at the
    fleet-process demo's robot (N=10) and at the bicycle OCP (N=30, nz=9),
    one problem each; and at the bench OCP (N=20) for the `"xla"` step's 72
    problems and the bench fleet's 4608, where the block's width follows
    the batch."""
    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        tmpc_bench_ocp)
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_bicycle)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        sqp_fused, sqp_single)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
        basic_problem, goal_demo_problem)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    settings = default_settings()
    bench_ocp = tmpc_bench_ocp(N=20, n_paths=8)[0]
    for name, ocp, problems in (
            ("golden", basic_ocp(15, 2), 1),
            ("basic", basic_problem()[0], 1),
            ("demo", goal_demo_problem(10)[0], 1),
            ("bicycle", build_ocp(*configuration_bicycle(settings),
                                  settings), 1),
            ("xla", bench_ocp, 72), ("bench fleet", bench_ocp, 4608)):
        tables = sqp_fused.ocp_tables(ocp, SQPConfig(), mirror=True)
        with torch.cuda.device(dev):
            for dtype in (torch.float32, torch.float64):
                p = sqp_single.launch_info(dtype, tables, problems)
                threads = 32 * p["warps_per_block"]
                log(f"launch plan sqp_single {str(dtype)[6:]} at {name} "
                    f"(T={tables.T}, m={tables.m}, (nx, nu) = ({ocp.nx}, "
                    f"{ocp.nu}), {problems} problems): one problem per "
                    f"block of {threads} threads ({p['warps_per_block']} "
                    f"warps), {p['smem_bytes_per_block']} B dynamic shared "
                    f"memory per block, {p['problems_per_sm']} problems "
                    f"(blocks) resident per SM, {p['registers']} registers "
                    f"and {p['local_bytes']} B local memory per thread")
                check(p["err"] == 0 and p["problems_per_sm"] > 0,
                      f"sqp_single {str(dtype)[6:]} at {name} fits the card")
                check(threads > 32, f"sqp_single {str(dtype)[6:]} at {name} "
                      f"spreads one problem over a block of {threads} > 32 "
                      f"threads")


def log_plans(dev, ocp, tables):
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, sqp_fused)

    with torch.cuda.device(dev):
        for dtype in (torch.float32, torch.float64):
            plans = {
                name: qp_cuda.launch_info(dtype, duals, tables.T, tables.m,
                                          max(tables.mh, 1), ocp.nx, ocp.nu)
                for name, duals in (("qp_ip (cold, lanes)", False),
                                    ("qp_ip_duals", True))}
            plans["sqp_fused"], plans["sqp_fused_linearize"] = (
                sqp_fused.launch_info(dtype, tables))
            for name, p in plans.items():
                log(f"launch plan {name} {str(dtype)[6:]} at T={tables.T}, "
                    f"m={tables.m}, (nx, nu) = ({ocp.nx}, {ocp.nu}): "
                    f"{p['warps_per_block']} warps (problems) "
                    f"per block, {p['smem_bytes_per_block']} B dynamic shared "
                    f"memory per block, {p['problems_per_sm']} problems "
                    f"resident per SM, {p['registers']} registers and "
                    f"{p['local_bytes']} B local memory per thread")
                check(p["err"] == 0 and p["problems_per_sm"] > 0,
                      f"{name} {str(dtype)[6:]} fits the card")


#: Wall seconds of each phase of this run, in order (``lap``).
PHASE_S = {}
_LAP_T = [0.0]


def lap(name):
    """The wall seconds since the last lap, recorded under ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = round(now - _LAP_T[0], 3)
    _LAP_T[0] = now


def timed_once(fn):
    """``(fn(), ms)``: one call timed by CUDA events (for the plain
    versions, whose one run both checks and times)."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = fn()
    e1.record()
    sync()
    return out, e0.elapsed_time(e1)


def spread(times):
    """min / max of a list of ms, for the log."""
    return f"min {min(times):.3f}, max {max(times):.3f}"


# ---------------------------------------------------------------------------
# The planner tick (bench.py::_e2e_tick): Planner -> TMPCOptimizer -> B2
# ---------------------------------------------------------------------------
#: Ticks of a run (the first TICK_SKIP not timed), as bench.py's phase 4.
TICKS, TICK_SKIP = 124, 4
#: Pipelined ticks run under torch.profiler after the timed ones.
PROFILED_TICKS = 4


def copy_windows(names):
    """The device trace (op names in start order) cut at B2's launches:
    ``(uploads, readbacks)`` per window, the first before B2's first
    launch, the last after its last one. ``len - 1`` is the number of B2
    launches in the trace."""
    windows = [[0, 0]]
    for n in names:
        if "sqp_fused_kernel<" in n:
            windows.append([0, 0])
        windows[-1][0] += "HtoD" in n
        windows[-1][1] += "DtoH" in n
    return [tuple(w) for w in windows]


def build_tick_scene(dev):
    """The tick of bench.py::_e2e_tick on ``dev`` at f32
    (``tools/common.py::tick_scene``: N=20, 3 obstacles, 4 guided planners
    and 1 unguided, the bench operating point); prewarmed (the kernels and
    the PRM library built)."""
    t = time.perf_counter()
    scene = tick_scene(dev, torch.float32, N_MAIN)
    log(f"tick planner built and prewarmed in {time.perf_counter() - t:.2f} s")
    return scene


def run_ticks(scene, pipelined, capture_at=None, profile_last=False,
              bench_timing=False, n_ticks=TICKS):
    """``n_ticks`` ticks of the scenario from its start (the first TICK_SKIP
    not timed), serial (``solve_mpc``) or pipelined (``solve_mpc_start``, the
    next tick's pedestrians, data and ``prepare``, ``solve_mpc_finish``).
    With ``capture_at`` the inputs dispatched at that tick are kept; with
    ``profile_last`` PROFILED_TICKS more ticks run under torch.profiler.
    Returns the run's records; a tick's host time is its wall time minus
    its wait on the device (the fetch).

    The serial loop of bench.py::_e2e_tick steps the pedestrians before it
    builds a tick's data, so the planner sees them one step ahead of the
    robot: stage k reads prediction step k-1, and stage 1 meets them where
    they will be. Its pipelined loop builds the first tick's data before
    any step, so every tick's data is one step older than the serial
    loop's. A pipelined run starts from data built after one step, so that
    both modes run the serial loop's scene; with ``bench_timing`` it starts
    from bench.py's data instead. The clearance is taken between the robot
    and the pedestrians at the same time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    planner, optimizer, clock = scene.planner, scene.optimizer, scene.clock
    state = scene.reset()
    peds, psim, build_data = scene.peds, scene.psim, scene.build_data
    r_robot = float(scene.settings["robot_radius"])

    last = {}
    if capture_at is not None:
        dispatch = optimizer._dispatch_batch

        def spy(params, xinit, warm):
            last["in"] = (params.copy(), np.array(xinit), warm.copy())
            return dispatch(params, xinit, warm)

        optimizer._dispatch_batch = spy

    def one_tick(data):
        if pipelined:
            planner.solve_mpc_start(state, data)
            # the pedestrians at the next tick: they stand there now on the
            # serial loop's scene, one step from here on bench.py's
            world = [p.position.copy() for p in peds]
            pred = planner.predicted_next_state(state)
            psim.step([pred.get_position()])
            if bench_timing:
                world = [p.position.copy() for p in peds]
            nxt = build_data(pred)
            planner.prepare(pred, nxt)
            out = planner.solve_mpc_finish()
        else:
            psim.step([state.get_position()])
            world = [p.position.copy() for p in peds]
            nxt = build_data(state)
            out = planner.solve_mpc(state, nxt)
        return (out, nxt, *scene.command(out), world)

    def advance(a, w, world):
        scene.advance(a, w)
        return min(np.linalg.norm(state.get_position() - pos)
                   - r_robot - p.radius for p, pos in zip(peds, world))

    data = build_data(state)
    planner.on_data_received(data, "reference_path")
    if pipelined and not bench_timing:
        psim.step([state.get_position()])
        data = build_data(state)
    x_start = state.get("x")
    rec = {"tick_ms": [], "host_ms": [], "wait_ms": [], "success": 0,
           "ticks": 0, "min_clearance": np.inf, "captured": None}
    gc.collect()
    try:
        for i in range(n_ticks):
            gc.disable()
            t0 = time.perf_counter()
            out, data, a, w, world = one_tick(data)
            wall = time.perf_counter() - t0
            gc.enable()
            if i >= TICK_SKIP:
                waited = optimizer.last_fetch_wait
                rec["tick_ms"].append(wall * 1e3)
                rec["host_ms"].append((wall - waited) * 1e3)
                rec["wait_ms"].append(waited * 1e3)
            rec["success"] += bool(out.success)
            rec["ticks"] += 1
            rec["min_clearance"] = min(rec["min_clearance"],
                                       advance(a, w, world))
            if i == capture_at:
                rec["captured"] = last["in"]
            if i % 16 == 15:
                gc.collect()
        if profile_last:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_TICKS):
                    out, data, a, w, world = one_tick(data)
                    rec["ticks"] += 1
                    rec["success"] += bool(out.success)
                    rec["min_clearance"] = min(rec["min_clearance"],
                                               advance(a, w, world))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            dev_events = sorted((e for e in prof.events()
                                 if e.device_type == DeviceType.CUDA),
                                key=lambda e: e.time_range.start)
            names = [e.name for e in dev_events]
            # device busy and span from the first traced B2 launch on (the
            # trace may have lost the ops before it, see tick_phase)
            first = next(i for i, n in enumerate(names)
                         if "sqp_fused_kernel<" in n)
            spans = [(e.time_range.start, e.time_range.end)
                     for e in dev_events[first:]]
            busy, end = 0.0, -1.0
            for lo, hi in spans:
                if hi > end:
                    busy += hi - max(lo, end)
                    end = hi
            rec["profile"] = {
                "device_ops": len(dev_events), "busy_ms": busy / 1e3,
                "span_ms": (end - spans[0][0]) / 1e3,
                "wall_ms": wall, "windows": copy_windows(names),
                "htod": sum("HtoD" in n for n in names),
                "dtoh": sum("DtoH" in n for n in names),
                "pageable": sum("Pageable" in n for n in names),
                "kernels": sorted({n.split("(")[0][:48] for n in names})}
    finally:
        gc.enable()
        optimizer.__dict__.pop("_dispatch_batch", None)
    rec["progress_m"] = state.get("x") - x_start
    rec["scene"] = (clock.t, state, data, out)
    for k in ("tick_ms", "host_ms", "wait_ms"):
        rec[k] = np.asarray(rec[k])
    return rec


def tick_phase(dev, card, reset_counts, counts, none):
    """The planner tick, serial and pipelined on the serial loop's scene,
    and pipelined on bench.py's (the pedestrians one step older, see
    ``run_ticks``), each run with the launch counts set to 0 just before
    it and read just after; B2 held against its plain version at the shape
    the tick gives it. Every run is held to one B2 launch per tick and
    nothing else, the fused backend, the C++ PRM and H-signature, success
    and progress; the first two to no contact with a pedestrian, the third
    only reports its clearance (the planner meets the pedestrians where
    they were a step before). Returns the kernel entry's numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.utils.profiling import (
        BENCHMARKERS)

    scene = build_tick_scene(dev)
    planner, optimizer = scene.planner, scene.optimizer
    check(optimizer.fleet_backend == "fused",
          f"tick fleet backend {optimizer.fleet_backend!r} == 'fused'")
    gg = optimizer.global_guidance
    check(gg.signature_backend == "cpp", f"guidance H-signature backend "
          f"{gg.signature_backend!r} == 'cpp'")
    P = optimizer.n_planners
    runs = {}
    for mode in ("serial", "pipelined", "pipelined, bench.py timing"):
        pipelined = mode != "serial"
        bench_timing = mode.endswith("timing")
        BENCHMARKERS.reset()
        reset_counts()
        rec = run_ticks(scene, pipelined, capture_at=None if pipelined else 60,
                        profile_last=mode == "pipelined",
                        bench_timing=bench_timing)
        got = counts()
        rec["b2"] = got["sqp_fused"]
        runs[mode] = rec
        check(got == {**none, "sqp_fused": rec["ticks"]},
              f"{mode} ticks: launches {got} (want one B2 launch per tick, "
              f"{rec['ticks']}, and no other kernel)")
        check(gg.ran_backend == "cpp",
              f"{mode} ticks: guidance PRM backend {gg.ran_backend!r} == 'cpp'")
        share = rec["success"] / rec["ticks"]
        check(share >= 0.95, f"{mode} ticks: success {rec['success']}/"
              f"{rec['ticks']} = {share:.4f} >= 0.95")
        check(rec["progress_m"] >= 10.0, f"{mode} ticks: progress "
              f"{rec['progress_m']:.3f} m >= 10 m along the path")
        clearance = (f"smallest clearance to a pedestrian "
                     f"{rec['min_clearance']:.4f} m (centre distance minus "
                     f"robot and pedestrian radii)")
        if bench_timing:
            log(f"{mode} ticks (not gated): {clearance}")
        else:
            check(rec["min_clearance"] > 0.0, f"{mode} ticks: {clearance} > 0")
        t_ms, h_ms, w_ms = rec["tick_ms"], rec["host_ms"], rec["wait_ms"]
        prm = np.asarray(BENCHMARKERS.get("guidance").durations) * 1e3
        log(f"[{card}] tick ({mode}, {len(t_ms)} timed of {rec['ticks']}, "
            f"P={P}, N={N_MAIN}, f32): median {np.median(t_ms):.3f} ms, p99 "
            f"{np.percentile(t_ms, 99):.3f} ms, spike share (> 1.5x median) "
            f"{np.mean(t_ms > 1.5 * np.median(t_ms)):.4f}; host-serial "
            f"(tick minus the fetch wait) median {np.median(h_ms):.3f} ms; "
            f"fetch wait median {np.median(w_ms):.3f} ms; guidance PRM "
            f"(BENCHMARKERS) median {np.median(prm):.3f} ms over {len(prm)}")
    prof = runs["pipelined"]["profile"]
    n = PROFILED_TICKS
    win = prof["windows"]
    log(f"[{card}] torch.profiler, {n} pipelined ticks (with the state "
        f"propagation between them), wall {prof['wall_ms']:.3f} ms: "
        f"{prof['device_ops']} device ops in the trace ({len(win) - 1} B2, "
        f"{prof['htod']} HtoD, {prof['dtoh']} DtoH copies, "
        f"{prof['pageable']} from pageable memory); from the first traced B2 "
        f"launch to the last op, device busy {prof['busy_ms']:.3f} of "
        f"{prof['span_ms']:.3f} ms, idle share "
        f"{1 - prof['busy_ms'] / prof['span_ms']:.4f}; (uploads, readbacks) "
        f"before B2's first traced launch, between its launches and after "
        f"its last: {win}; ops: {prof['kernels']}")
    # After the fleet phases the trace loses the first few device ops of
    # the profiled run (the first tick's upload, the small kernels before
    # its B2, at times that B2), which the launch counts saw: a readback
    # before the first traced B2 launch is a tick whose B2 the trace lost.
    # Every upload after the first tick's lies in the trace, as does every
    # readback.
    lost_b2 = win[0][1]
    check(prof["pageable"] == 0 and len(win) - 1 + lost_b2 == n
          and win[0][0] <= 1 and win[0][0] >= lost_b2
          and all(w == (1, 1) for w in win[1:-1]) and win[-1] == (0, 1),
          f"profiled ticks: {n} B2 launches, {len(win) - 1} of them in the "
          f"trace and {lost_b2} before its first op; one pinned upload before "
          f"each launch after the first tick's, one readback after each "
          f"launch, no copy from pageable memory (the kernel's tables stay "
          f"on the card)")

    # B2 at the tick's shape against its plain version
    ocp = planner.solver.ocp
    err, k_ms, p_ms, a32, mach = b2_against_plain(
        dev, card, ocp, bench_config(), runs["serial"]["captured"],
        "the tick's shape")
    check_ip_count(mach, ocp, "TICK", "the tick")
    pipe = runs["pipelined"]
    return dict(scene=(planner, gg, *runs["serial"]["scene"]),
                launches=pipe["b2"],
                launches_per_tick=pipe["b2"] / pipe["ticks"],
                err=err, ms=k_ms, plain_ms=p_ms,
                flops=roofline.sqp_flops(
                    P, BENCH_SCHEDULE, lin=roofline.TICK_LIN_FLOPS,
                    merit=roofline.TICK_MERIT_FLOPS,
                    ip_iter=roofline.TICK_IP_ITER_FLOPS),
                n_bytes=roofline.tensor_bytes(*a32, a32[2]) + 8 * P)


# ---------------------------------------------------------------------------
# The single-instance solve (S1) and BASELINE config 2
# ---------------------------------------------------------------------------
#: The golden's config (tests/test_golden.py); BASELINE's f32 gate is
#: tools/common.py's (GATE_CFG, GATE_B, GATE_FLAVOURS).
GOLDEN_CFG = dict(n_sqp=30, n_qp_iter=20, mu_min=1e-10)
#: The evaluators at tools/bench_rollout.py's shape (its defaults: 4096
#: episodes of the goal and contouring evaluators, 1024 x 4 robots, 819 x 5
#: T-MPC planners).
ROLLOUT_N, ROLLOUT_TICKS = 20, 60
BASIC_TICKS = 3
#: Share of the contouring evaluator's first-tick problems on which f32 B2
#: must lie within 1e-4 (per problem, relative) of its plain version:
#: 0.995117 on an H100 80GB HBM3 (700 W); a fault on one warp slot of a
#: 2-warp block would take half the problems.
F32_ROLLOUT_SHARE = 0.98
#: The multi-robot and T-MPC evaluators' f64 kernel-vs-plain rollouts are
#: held to the fused kernel's per-problem gate, not to 1e-8: each carries
#: from tick to tick a decision that round-off can tip, a QP frozen at its
#: residual tolerance (1e-5) one iteration sooner or later, whose plan the
#: other robots then read, or the selection among guided planners that
#: converge to one trajectory. The multi-robot rollout parted by 1.5e-8 on
#: an H100 80GB HBM3 (700 W).
COUPLED_F64_ROLLOUT_GATE = FUSED_F64_GATE


def sync():
    torch.cuda.synchronize()


#: Seconds a padded trace stays open after its last op.
TRACE_SETTLE_S = 0.25


def device_trace(fn, pad=0):
    """The device ops (kernels, copies, fills) of one call of fn in start
    order, by a torch.profiler trace of the device alone (a trace of the
    host's ops too costs seconds for a few thousand launches). With ``pad``,
    ``pad`` one-element additions run before and after fn inside the trace,
    and the trace stays open ``TRACE_SETTLE_S`` longer: the card's traces of
    long rollouts have dropped their first or last device ops (up to ~460
    of a T-MPC rollout's ~17800 on an H100 80GB HBM3, 700 W), and the
    padding is what such a loss then takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")

    def padding():
        for _ in range(pad):
            marker.add_(1.0)
        sync()

    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        sync()
        with profile(activities=activities) as prof:
            padding()
            fn()
            sync()
            padding()
            if pad:
                time.sleep(TRACE_SETTLE_S)
        ops = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if ops:
            return ops
        log("a trace of the device alone held no device op; tracing the "
            "host's ops too")
    return ops


def solve_ops(fn):
    """The names of the device ops of one call of fn (a solve and its
    readback), by a padded trace with the padding's ops taken out (their
    names from a trace of the padding alone)."""
    pad_names = {e.name for e in device_trace(lambda: None, pad=64)}
    return [e.name for e in device_trace(fn, pad=64)
            if e.name not in pad_names]


def host_syncs(fn):
    """The calls in fn() that wait for the device, as torch's sync debug
    mode reports them: ``file:line`` of each (the Python line that called
    the op)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def s1_against_plain(dev, card, ocp, cfg, args, counts_s1, name,
                     launches, reps=20):
    """S1 at f64 on one problem (numpy ``args``: all_params (N, npar), x0,
    z_init) against its plain version on the card, the same inputs: the
    same success, max|dZ| / (1 + max|Z|) <= FUSED_F64_GATE (B2's f64
    gate). Times the launch alone (the input blocks laid out beforehand)
    and the plain solve, and returns the kernel entry numbers (bound from
    ``counts_s1``, a ``roofline.SingleCounts``, at the FP64 rate)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _phases_of, make_sqp_solver)

    s1 = make_sqp_solver(ocp, cfg, dtype=torch.float64, device=dev).batched
    ins = tuple(torch.as_tensor(np.asarray(a)[None], dtype=torch.float64,
                                device=dev) for a in args)
    r_k = s1(*ins)
    sync()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    r_p = s1.reference(*ins)
    e1.record()
    sync()
    p_ms = e0.elapsed_time(e1)
    err = (r_k.z - r_p.z).abs().max().item()
    rel = err / (1.0 + r_p.z.abs().max().item())
    log(f"f64 S1 at {name} (T={ocp.N + 1}, nz={ocp.nvar}, {cfg.n_sqp} x "
        f"{cfg.n_qp_iter} or {cfg.qp_iter_schedule}, {cfg.regularization}): "
        f"max|dZ| {err:.3e} vs plain, rel {rel:.3e}, success "
        f"{bool(r_k.success[0])} / {bool(r_p.success[0])}, cost "
        f"{float(r_k.cost[0]):.12f} / {float(r_p.cost[0]):.12f}, qp_comp "
        f"{float(r_k.qp_comp[0]):.3e} / {float(r_p.qp_comp[0]):.3e}")
    check(bool(r_k.success[0]) == bool(r_p.success[0])
          and rel <= FUSED_F64_GATE, f"f64 S1 = plain at {name}: same "
          f"success, max|dZ| / (1 + max|Z|) <= {FUSED_F64_GATE:g}")
    x_in = s1.layout(*ins)
    k_ms, k_all = cuda_time_ms(lambda: s1.launch(x_in), reps=reps)
    log(f"[{card}] S1 at {name} (f64, one problem): {k_ms:.3f} ms per "
        f"launch (median of {reps}; {spread(k_all)}), plain {p_ms:.1f} ms "
        f"on the card")
    T, nz = ocp.N + 1, ocp.nvar
    return dict(launches=launches, err=err, ms=k_ms, plain_ms=p_ms,
                flops=roofline.single_flops(
                    _phases_of(cfg), counts_s1, T, nz,
                    mirror=cfg.regularization == "mirror",
                    track_best=cfg.track_best),
                n_bytes=8 * (x_in.numel() + T * nz + 5),
                peak=roofline.PEAK_FP64_FLOPS)


def golden_single_phase(dev, card, reset_counts, counts, none):
    """(a) The contouring_2obs golden through make_sqp_solver on the card at
    f64: one launch of S1 and no other kernel; Z within atol 1e-6, cost
    within rtol 1e-8, success; its ms, its device ops, which of its calls
    wait for the device; then S1 against its plain version on the card
    (``s1_against_plain``). Returns the solution Z (numpy) and S1's
    kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, fetch_result_single, make_sqp_solver)

    gold = np.load(os.path.join(ROOT, "tests", "golden", "contouring_2obs.npz"))
    ocp = basic_ocp(15, 2)
    cfg = SQPConfig(**GOLDEN_CFG)
    solve = make_sqp_solver(ocp, cfg, dtype=torch.float64, device=dev)
    args = (gold["P"], gold["x0"], gold["z_init"])
    reset_counts()
    sync()
    t0 = time.perf_counter()
    res = solve(*args)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    check(got == {**none, "sqp_single": 1}, f"single-instance golden solve: "
          f"one S1 launch and no other kernel ({got})")
    check(res.z.device.type == "cuda", f"solution on {res.z.device}")
    zerr = float(np.abs(res.z.cpu().numpy() - gold["Z"]).max())
    cost = float(res.cost)
    log(f"single-instance golden (f64, cuda, S1): max|Z - Z_gold| "
        f"{zerr:.3e}, cost {cost:.12f} vs {float(gold['cost']):.12f}, eq_res "
        f"{float(res.eq_res):.3e}, qp_comp {float(res.qp_comp):.3e}")
    check(bool(res.success), "single-instance golden solve succeeded")
    check(zerr <= 1e-6, "single-instance golden Z within atol 1e-6")
    check(abs(cost - float(gold["cost"])) <= 1e-8 * abs(float(gold["cost"])),
          "single-instance golden cost within rtol 1e-8")
    names = solve_ops(lambda: fetch_result_single(solve(*args)))
    waits = host_syncs(lambda: fetch_result_single(solve(*args)))
    log(f"[{card}] single-instance solve (N=15, {cfg.n_sqp} x "
        f"{cfg.n_qp_iter}, f64, S1): {ms:.1f} ms per solve from numpy "
        f"inputs; {len(names)} device ops per solve and readback "
        f"({sum('sqp_single' in n for n in names)} S1): {names}; calls that "
        f"wait for the device (sync debug mode): {waits}")
    entry = s1_against_plain(dev, card, ocp, cfg, args, roofline.S1_GOLDEN,
                             "the contouring_2obs golden", got["sqp_single"])
    return res.z.cpu().numpy(), entry


def baseline_gate_phase(dev, card, reset_counts, counts, none, flavour,
                        ref_z=None):
    """BASELINE's f32 gate of one flavour (``tools/validate.py::gate``, the
    port's examples/validate_tpu.py; ``GATE_FLAVOURS``): the golden's
    problem tiled to B=4 at the f32 operating point through B1 (``"pallas"``), through B2 (``"fused"``) and
    through S1 (``"xla"``),
    each run with the launch counts set to 0 before it; max |U32 - U64| <=
    1e-3 against the committed CPU-f64 controls for each; beside it, where
    given, ``ref_z``, an f64 solve of the golden (the port's make_sqp_solver
    on the card, the golden's config, mu_min 1e-10, where
    examples/validate_tpu.py's cross-check solves again at 1e-9). Then B1
    at the gate's QPs against its plain version, and B2 on the tiled
    problems against its plain version at f64. Returns B1's and B2's
    kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, _f32_safe, _make_machinery, _phases_of,
        make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import validate

    consts = GATE_FLAVOURS[flavour][3]
    ocp, P_g, x_g, z_g, U64 = gate_inputs(flavour)
    nu = ocp.nu
    cfg = SQPConfig(**GATE_CFG)
    tiled = (np.tile(P_g[None], (GATE_B, 1, 1)),
             np.tile(x_g[None], (GATE_B, 1)),
             np.tile(z_g[None], (GATE_B, 1, 1)))
    want = {"pallas": {**none, "qp_ip": cfg.n_sqp},
            "fused": {**none, "sqp_fused": 1},
            "xla": {**none, "sqp_single": 1}}
    launches = {}
    for backend in ("pallas", "fused", "xla"):
        reset_counts()
        g = validate.gate(flavour, backend, dev)
        sync()
        got = counts()
        launches[backend] = got
        check(got == want[backend], f"{flavour} f32 gate through {backend!r}: "
              f"launches {got} (want {want[backend]})")
        ref = "" if ref_z is None else (
            f"; vs the port's f64 make_sqp_solver on the card (the golden "
            f"phase's solve) {np.abs(g['U'] - ref_z[:-1, :nu]).max():.3e}; "
            f"golden vs that solve {np.abs(U64 - ref_z[:-1, :nu]).max():.3e}")
        log(f"[{card}] BASELINE f32 gate, {flavour}+ellipsoid (nx={ocp.nx}), "
            f"{backend!r}: max|U32 - U64| {g['err']:.3e} over {GATE_B} "
            f"problems (gate {GATE_TOL:g}), success "
            f"{g['out'].success.tolist()}{ref}")
        check(g["ok"], f"BASELINE f32 gate, {flavour}, through {backend!r}: "
              f"max|U32 - U64| {g['err']:.3e} <= {GATE_TOL:g}, every problem "
              f"solved")

    # B1 at the gate's QPs (the golden's problem linearized at its start):
    # held to its plain version at f64, its f32 gap reported
    def gate_qps(dtype):
        mach = _make_machinery(ocp, _f32_safe(cfg, dtype), dtype, dev)
        P, x0, Z = (torch.as_tensor(a, dtype=dtype, device=dev) for a in tiled)
        qp = mach.build_qp(Z, torch.cat([P, P[:, -1:]], dim=1), x0)
        kw = dict(nu=nu, n_iters=cfg.n_qp_iter, mu_min=1e-6, w_max=1e6,
                  row_meta=mach.row_meta)
        return (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask,
                qp.r0), kw, mach

    for dtype in (torch.float64, torch.float32):
        qa, kw, mach = gate_qps(dtype)
        dz_k = qp_cuda.solve_qp_batched(*qa, **kw)
        dz_p = qp_cuda.ip_solve_reference(*qa, **kw)
        sync()
        err = (dz_k - dz_p).abs().max().item()
        scale = 1.0 + dz_p.abs().max().item()
        log(f"{str(dtype)[6:]} B1 at the {flavour} gate's QPs ({GATE_B} "
            f"problems, T={qa[0].shape[1]}, nx={ocp.nx}, m={qa[5].shape[2]},"
            f" {cfg.n_qp_iter} iterations): max|ddz| {err:.3e}, max|dz| "
            f"{scale - 1:.3e}")
        if dtype == torch.float64:
            check(err <= QP_F64_GATE * scale, f"f64 B1 = plain at the "
                  f"{flavour} gate's QPs: max|ddz| <= {QP_F64_GATE:g} "
                  f"(1 + max|dz|)")
    k_ms, k_all = cuda_time_ms(lambda: qp_cuda.solve_qp_batched(*qa, **kw),
                               reps=20)
    p_ms, _ = cuda_time_ms(lambda: qp_cuda.ip_solve_reference(*qa, **kw),
                           reps=1, warmup=0)
    log(f"[{card}] B1 at the {flavour} gate's QPs: {k_ms:.4f} ms per launch "
        f"(median of 20; {spread(k_all)}), plain {p_ms:.3f} ms")
    T, m = qa[0].shape[1], qa[5].shape[2]
    mh = sum(meta[0] == "h" for meta in mach.row_meta)
    ip_iter, lin, merit = (getattr(roofline, f"{consts}_{kind}_FLOPS")
                           for kind in ("IP_ITER", "LIN", "MERIT"))
    check(roofline.ip_iter_flops(mach.row_meta, mach.stage_mask, ocp.nx, nu)
          == ip_iter, f"IP iteration count at the {flavour} gate's rows and "
          f"mask = {consts}_IP_ITER_FLOPS {ip_iter}")
    b1 = dict(launches=launches["pallas"]["qp_ip"], err=err, ms=k_ms,
              plain_ms=p_ms,
              flops=roofline.ip_flops(GATE_B, cfg.n_qp_iter, ip_iter=ip_iter),
              n_bytes=roofline.qp_bytes(T, ocp.nx, nu, m, mh, GATE_B, 4))

    # B2 on the tiled problems: f64 against its plain version, f32 timed
    fs64 = make_fleet_sqp_solver(ocp, cfg, dtype=torch.float64, device=dev,
                                 backend="fused")
    r_k, r_p = fs64(*tiled), fs64.reference(*tiled)
    sync()
    rel = ((r_k.z - r_p.z).abs().amax(dim=(1, 2))
           / (1.0 + r_p.z.abs().amax(dim=(1, 2))))
    b2_err = (r_k.z - r_p.z).abs().max().item()
    log(f"f64 B2 at the {flavour} gate ({GATE_B} problems, {cfg.n_sqp} x "
        f"{cfg.n_qp_iter}): max|dZ| {b2_err:.3e}, max rel "
        f"{rel.max().item():.3e}")
    check(bool((r_k.success == r_p.success).all())
          and rel.max().item() <= FUSED_F64_GATE, f"f64 B2 = plain at the "
          f"{flavour} gate: same success, per problem max|dZ| / (1 + max|Z|) "
          f"<= {FUSED_F64_GATE:g}")
    fs = make_fleet_sqp_solver(ocp, cfg, dtype=torch.float32, device=dev,
                               backend="fused")
    a32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in tiled)
    f_ms, f_all = cuda_time_ms(lambda: fs(*a32), reps=10)
    fp_ms, _ = cuda_time_ms(lambda: fs.reference(*a32), reps=1, warmup=0)
    log(f"[{card}] B2 at the {flavour} gate ({GATE_B} problems, f32): "
        f"{f_ms:.3f} ms per launch (median of 10; {spread(f_all)}), plain "
        f"fused_fleet_reference {fp_ms:.1f} ms")
    b2 = dict(launches=launches["fused"]["sqp_fused"], err=b2_err, ms=f_ms,
              plain_ms=fp_ms,
              flops=roofline.sqp_flops(GATE_B, _phases_of(cfg), lin=lin,
                                       merit=merit, ip_iter=ip_iter),
              n_bytes=roofline.tensor_bytes(
                  torch.cat([a32[0], a32[0][:, -1:]], dim=1), a32[1], a32[2],
                  a32[2]) + 8 * GATE_B)
    return dict(b1=b1, b2=b2)


def basic_tick_phase(dev, card, reset_counts, counts, none):
    """(c) The configuration_basic planner tick (BASELINE config 2) at
    default_settings (N=30, 4 obstacles, 10 x 18 SQP, f64) on the card:
    Planner.solve_mpc -> Solver.solve, BASIC_TICKS ticks on a straight path
    among the tick phase's crossing pedestrians, on a simulated clock (no
    budget: the full ladder entry every tick), the launch counts set to 0
    before them. Every tick succeeds, no contact, the solver's tensors on
    the card, one S1 launch per tick and no other kernel, and the first
    tick equals the same solve on the CPU within atol 1e-6; the tick and
    solve medians beside the 44 ms budget; then S1 at the first tick's
    inputs against its plain version on the card. Returns S1's kernel
    entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        build_planner, configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        fetch_result_single, make_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils.profiling import (
        BENCHMARKERS)

    settings = default_settings()
    model, modules = configuration_basic(settings)
    planner = build_planner(model, modules, settings, dtype=torch.float64,
                            device=dev)
    solver = planner.solver
    check(solver.device.type == "cuda", f"basic planner's solver on "
          f"{solver.device}")
    N = solver.N
    r_robot = float(settings["robot_radius"])
    scene = TickScene(planner, model, settings, clock=None)
    state = scene.state

    def tick(first):
        scene.psim.step([state.get_position()])
        data = scene.build_data(state)
        if first:
            planner.on_data_received(data, "reference_path")
        out = planner.solve_mpc(state, data)
        scene.advance(*scene.command(out))
        return out, min(np.linalg.norm(state.get_position() - p.position)
                        - r_robot - p.radius for p in scene.peds)

    full = solver._iter_ladder[0]
    solve_full, devices = solver._ladder_fn(full), set()

    def spy(*args):
        res = solve_full(*args)
        devices.add(res.z.device.type)
        return res

    solver._ladder_fns[full] = spy
    BENCHMARKERS.reset()
    reset_counts()
    tick_ms, clearance, ladder, first_in, first_z = [], np.inf, set(), None, None
    for i in range(BASIC_TICKS):
        sync()
        t0 = time.perf_counter()
        out, clear = tick(i == 0)
        sync()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        check(out.success, f"basic planner tick {i} succeeded")
        clearance = min(clearance, clear)
        ladder.add(solver.last_iterations_run)
        if i == 0:
            first_in = (solver.params.data.copy(), solver._xinit.copy(),
                        solver._loaded_warmstart.copy())
            first_z = solver.get_output_trajectory()
    got = counts()
    check(got == {**none, "sqp_single": BASIC_TICKS}, f"basic planner "
          f"ticks: one S1 launch per tick and no other kernel ({got})")
    check(clearance > 0.0, f"basic planner ticks: smallest clearance to a "
          f"pedestrian {clearance:.4f} m > 0")
    solver._ladder_fns[full] = solve_full
    check(ladder == {full}, f"every tick ran the full ladder entry "
          f"({sorted(ladder)} == [{full}])")
    check(devices == {"cuda"}, f"the ticks' solves returned tensors on "
          f"{devices}")
    cpu = fetch_result_single(make_sqp_solver(
        solver.ocp, solver.config, dtype=torch.float64, device="cpu")(
            *first_in))
    gap = float(np.abs(cpu.z - first_z).max())
    log(f"basic planner's first tick vs the same solve on the CPU (f64): "
        f"max|dZ| {gap:.3e}")
    check(gap <= 1e-6, "basic planner's first tick = the CPU solve within "
          "atol 1e-6")
    solve_ms = np.asarray(BENCHMARKERS.get("optimization").durations) * 1e3
    # device ops of one tick's solve: Solver.solve's upload, S1, readback;
    # the modules' work is on the host
    ops = solve_ops(lambda: fetch_result_single(solve_full(*first_in)))
    log(f"[{card}] basic planner tick (configuration_basic, N={N}, "
        f"{solver.config.n_sqp} x {solver.config.n_qp_iter}, f64, S1, "
        f"{BASIC_TICKS} ticks, ladder entry {full} of "
        f"{solver._iter_ladder}): tick {np.median(tick_ms):.1f} ms median "
        f"({[round(t, 1) for t in tick_ms]}), solve "
        f"{np.median(solve_ms):.1f} ms median, against the solver's "
        f"{1e3 / float(settings.get('control_frequency', 20)) - 6.0:.0f} ms "
        f"budget (1 / control_frequency - 6 ms); {len(ops)} device ops per "
        f"tick's solve: {ops}; smallest "
        f"clearance {clearance:.4f} m; progress {state.get('x'):.3f} m")
    return s1_against_plain(dev, card, solver.ocp, solver.config, first_in,
                            roofline.S1_BASIC, "the configuration_basic "
                            "tick", BASIC_TICKS, reps=10)


#: The "xla" fleet check's plans: the bench's small batch (tools/bench.py
#: SMALL_B), 8 plans x 9 planners = 72 problems.
XLA_PLANS = 8
#: f32 S1 against its f32 plain version there, per problem max|dZ| / (1 +
#: max|Z|): at most 7.6e-5, median 3.5e-7 on an H100 80GB HBM3 (700 W).
S1_F32_MAX_REL = 1e-3


def xla_fleet_phase(dev, card, reset_counts, counts, none):
    """(c2) ``backend="xla"`` on the card: the T-MPC++ fleet step at the
    bench's small batch (XLA_PLANS plans x 9 planners, N=20, f32, the
    bench config) through S1, the launch counts set to 0 before it: one S1
    launch per step and no other kernel, best-of-9 success >= 0.95, and its
    plans agree with the fused step's as the other backends' do (any_success
    on >= 99% of plans, the median relative best_cost gap printed); both
    steps timed. Then S1 on the fleet's 72 problems against its plain
    version on the same inputs at f64 (every problem within
    FUSED_F64_GATE, the same success mask) and at f32 (the same success
    mask, the median problem within 1e-4, B2's f32 gate, every problem
    within S1_F32_MAX_REL), each beside B2 on the same problems, and
    S1's launch alone at f32. Returns S1's kernel entry numbers (the f32
    launch, its max|dZ| against the f32 plain version)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        roofline, sqp_single)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        make_batched_tmpc_step)

    cfg = bench_config()
    ocp, args = bench_fleet(XLA_PLANS, torch.float32, dev)
    step_x = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32,
                                    device=dev, backend="xla")
    step_f = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32,
                                    device=dev, backend="fused")
    reset_counts()
    out_x = step_x(*args)
    sync()
    got = counts()
    check(got == {**none, "sqp_single": 1}, f"xla fleet step: one S1 launch "
          f"and no other kernel ({got})")
    out_f = step_f(*args)
    sync()
    n = XLA_PLANS * (N_PATHS + 1)
    success = out_x.any_success.float().mean().item()
    agree = (out_x.any_success == out_f.any_success).float().mean().item()
    same = (out_x.best_index == out_f.best_index).float().mean().item()
    both = out_x.any_success & out_f.any_success
    rel_cost = ((out_x.best_cost - out_f.best_cost).abs()
                / out_f.best_cost.abs().clamp(min=1e-12))[both]
    x_ms, x_all = cuda_time_ms(lambda: step_x(*args), reps=10)
    f_ms, _ = cuda_time_ms(lambda: step_f(*args), reps=10)
    log(f"[{card}] xla fleet step ({XLA_PLANS} plans x {N_PATHS + 1} = {n} "
        f"problems, f32, S1): success_rate {success:.6f} (fused "
        f"{out_f.any_success.float().mean().item():.6f}), any_success "
        f"agreement with the fused step {agree:.6f}, same planner "
        f"{same:.6f}, median rel best_cost diff "
        f"{rel_cost.median().item() if both.any() else float('nan'):.6e}; "
        f"step {x_ms:.3f} ms (median of 10; {spread(x_all)}), fused step "
        f"{f_ms:.3f} ms")
    check(success >= 0.95, "xla fleet step: best-of-9 success_rate >= 0.95")
    check(agree >= 0.99, "xla fleet step any_success agrees with the fused "
          "step on >= 99% of plans")

    # S1 on the fleet's problems, each dtype against its own plain version
    # on the same inputs; B2 on the same problems shows what of the steps'
    # best_cost gap is the algorithm (it stays at f64) and what round-off
    flat = flat_fleet(args)
    fused = {dt: make_fleet_sqp_solver(ocp, cfg, dtype=dt, device=dev,
                                       backend="fused")
             for dt in (torch.float64, torch.float32)}
    T, nz = ocp.N + 1, ocp.nvar
    flops = n * roofline.single_flops(BENCH_SCHEDULE, roofline.S1_BENCH, T,
                                      nz, mirror=False,
                                      track_best=cfg.track_best)
    costs = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        ins = tuple(a.to(dtype) for a in flat)
        s1 = sqp_single.make_single_solver(ocp, cfg, dtype=dtype, device=dev)
        r_k = s1(*ins)
        sync()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        r_p = s1.reference(*ins)
        e1.record()
        sync()
        p_ms = e0.elapsed_time(e1)
        r_b2 = fused[dtype](*ins)
        sync()
        rel = ((r_k.z - r_p.z).abs().amax(dim=(1, 2))
               / (1.0 + r_p.z.abs().amax(dim=(1, 2))))
        err = (r_k.z - r_p.z).abs().max().item()
        costs[dtype] = r_k.cost.double()
        log(f"{tag} S1 on the xla fleet's {n} problems vs its plain version: "
            f"max|dZ| {err:.3e}, per problem rel median "
            f"{rel.median().item():.3e} max {rel.max().item():.3e} (<= 1e-4 "
            f"on {(rel <= 1e-4).float().mean().item():.4f}), same success "
            f"{(r_k.success == r_p.success).float().mean().item():.4f}, "
            f"success {r_k.success.float().mean().item():.4f} (plain "
            f"{r_p.success.float().mean().item():.4f}), cost rel "
            f"{med_rel(r_k.cost, r_p.cost):.3e} median; vs B2 at {tag} on "
            f"the same problems: cost rel {med_rel(r_k.cost, r_b2.cost):.3e} "
            f"median, success {r_b2.success.float().mean().item():.4f}")
        if dtype == torch.float64:
            check(bool((r_k.success == r_p.success).all())
                  and rel.max().item() <= FUSED_F64_GATE, f"f64 S1 = plain "
                  f"on the xla fleet: same success, per problem max|dZ| / "
                  f"(1 + max|Z|) <= {FUSED_F64_GATE:g}")
        else:
            check(bool((r_k.success == r_p.success).all())
                  and rel.median().item() <= 1e-4
                  and rel.max().item() <= S1_F32_MAX_REL, f"f32 S1 = plain "
                  f"on the xla fleet: same success, median rel <= 1e-4 (B2's "
                  f"f32 gate), every problem <= {S1_F32_MAX_REL:g}")
    # the row: the step's own dtype, f32 (s1, err and p_ms from the loop's
    # last pass)
    x_in = s1.layout(*ins)
    k_ms, k_all = cuda_time_ms(lambda: s1.launch(x_in), reps=20)
    log(f"[{card}] S1 on the xla fleet ({n} problems, f32): {k_ms:.3f} ms "
        f"per launch (median of 20; {spread(k_all)}), plain {p_ms:.1f} ms")
    log(f"S1 on the xla fleet's {n} problems, f32 vs f64: cost rel "
        f"{med_rel(costs[torch.float32], costs[torch.float64]):.3e} median")
    return dict(launches=got["sqp_single"], err=err, ms=k_ms, plain_ms=p_ms,
                flops=flops, n_bytes=4 * (x_in.numel() + n * (T * nz + 5)))


def med_rel(a, b):
    """Median over problems of |a - b| / max(|b|, 1e-12), a and b finite."""
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return ((a - b).abs() / b.abs().clamp(min=1e-12))[ok].median().item()


def evaluator_phase(dev, card, reset_counts, counts, none, ev,
                    short_ticks=3, f64_gate=1e-8, f32_share=None):
    """One evaluator of tools/bench_rollout.py (``ev``, its
    ``evaluators()`` description) at the tool's shape, f32, ``"auto"`` ->
    ``"fused"``: exactly one B2 launch per tick and nothing else, the
    launch counts set to 0 before the run; success >= 0.9 (any planner's,
    for the T-MPC evaluator); episodes/s by the host clock over two batches
    (inputs uploaded and metrics read back inside); one profiled rollout
    has no copy between its B2 launches and one readback after the last;
    f64 kernel = plain (``fused_fleet_reference``) on an 8-episode,
    ``short_ticks``-tick rollout, every metric within ``f64_gate``; B2 alone
    on the evaluator's first tick against plain: at f64 every problem
    within FUSED_F64_GATE, at f32 the median on each warp slot within 1e-4
    (and, with ``f32_share``, the share of problems within 1e-4). Returns
    B2's kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _phases_of, make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_rollout import (  # noqa: E501
        read_metrics, throughput)

    rollout, ocp = ev.make(ROLLOUT_TICKS, torch.float32, dev)
    check(rollout.backend == "fused", f"{ev.name} evaluator backend "
          f"{rollout.backend!r} == 'fused' ('auto' on cuda)")
    B, n = ev.batch, ev.batch * ev.planners
    reset_counts()
    m = read_metrics(rollout(*ev.scenes(B, 0)))
    got = counts()
    want = {**none, "sqp_fused": ROLLOUT_TICKS}
    check(got == want, f"{ev.name} evaluator: launches {got} (want one B2 "
          f"launch per tick, {ROLLOUT_TICKS}, and nothing else)")
    final = m["final_states" if "final_states" in m else "final_state"]
    check(np.isfinite(final).all() and final.shape[0] == B,
          f"{ev.name} evaluator final state finite, shape {final.shape}")
    m, wall = throughput(ev, rollout, seeds=(1, 2))
    summary = ev.summary(m)
    eps = B / float(np.median(wall))
    log(f"[{card}] {ev.name} evaluator (B={B} x {ev.planners} = {n} problems "
        f"per tick, N={ROLLOUT_N}, {ROLLOUT_TICKS} ticks, f32, fused): "
        f"{eps:.1f} episodes/s ({[round(w, 3) for w in wall]} s per batch, "
        f"inputs uploaded and metrics read back inside), "
        f"{n * ROLLOUT_TICKS / float(np.median(wall)):.0f} problems solved "
        f"per s; {summary}")
    key = "plan_success" if "plan_success" in summary else "solve_success"
    check(summary[key] >= 0.9, f"{ev.name} evaluator {key} "
          f"{summary[key]:.4f} >= 0.9")

    # one profiled rollout: nothing crosses between ticks. The padding
    # outlasts what the card's traces have dropped at their end (device_trace)
    scenes = ev.scenes(B, 3)
    names = [e.name for e in device_trace(
        lambda: read_metrics(rollout(*scenes)), pad=1024)]
    win = copy_windows(names)
    log(f"{ev.name} evaluator, one profiled rollout: {len(names)} device "
        f"ops, {len(win) - 1} B2 launches in the trace; (uploads, readbacks) "
        f"before the first, between launches, after the last: "
        f"{sorted(set(win[1:-1]))} between, {win[0]} before, {win[-1]} after")
    check(len(win) - 1 >= ROLLOUT_TICKS - 1
          and all(w == (0, 0) for w in win[1:-1]) and win[-1] == (0, 1),
          f"{ev.name} evaluator: no copy between B2 launches and one "
          f"readback after the last")

    # f64 kernel = plain on a short rollout
    small, _ = ev.make(short_ticks, torch.float64, dev, "fused")
    s_scenes = ev.scenes(8, 4)
    mk = read_metrics(small(*s_scenes))
    with plain_fused_solver(small.fleet_solve):
        n0 = counts()["sqp_fused"]
        mp = read_metrics(small(*s_scenes))
        check(counts()["sqp_fused"] == n0,
              f"plain {ev.name} evaluator launched no B2")
    worst = max(float(np.abs(mk[k] - mp[k]).max()) for k in mk)
    log(f"f64 {ev.name} evaluator (B=8 x {ev.planners}, {short_ticks} "
        f"ticks), kernel vs plain: max|d| over every metric {worst:.3e}")
    check(worst <= f64_gate, f"f64 {ev.name} evaluator kernel = plain: "
          f"every metric within {f64_gate:g}")

    # B2 alone at the evaluator's shape: its first tick
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in ev.scenes(B, 0))
    P, x, Z = ev.first_tick(rollout, ocp, args)
    fs = rollout.fleet_solve
    # f64, every problem held to the plain version
    fs64 = make_fleet_sqp_solver(ocp, rollout.config, dtype=torch.float64,
                                 device=dev, backend="fused")
    a64 = tuple(a.double() for a in (P, x, Z))
    r64k, r64p = fs64(*a64), fs64.reference(*a64)
    sync()
    rel64 = ((r64k.z - r64p.z).abs().amax(dim=(1, 2))
             / (1.0 + r64p.z.abs().amax(dim=(1, 2))))
    log(f"f64 B2 at the {ev.name} evaluator's first tick ({n} problems): "
        f"max|dZ| {(r64k.z - r64p.z).abs().max().item():.3e}, max rel "
        f"{rel64.max().item():.3e}, success "
        f"{r64k.success.float().mean().item():.6f} (plain "
        f"{r64p.success.float().mean().item():.6f})")
    check(bool((r64k.success == r64p.success).all())
          and rel64.max().item() <= FUSED_F64_GATE,
          f"f64 B2 = plain at the {ev.name} evaluator's shape: same success, "
          f"every problem max|dZ| / (1 + max|Z|) <= {FUSED_F64_GATE:g}")
    del fs64, a64, r64k, r64p
    # f32: per problem, by warp slot (problem b runs on warp b % W of its
    # block, W = 1, 2 or 4) and over all problems
    rk = fs(P, x, Z)
    rp, p_ms = timed_once(lambda: fs.reference(P, x, Z))
    err = (rk.z - rp.z).abs().max().item()
    rel = ((rk.z - rp.z).abs().amax(dim=(1, 2))
           / (1.0 + rp.z.abs().amax(dim=(1, 2))))
    slot_med = [rel[s::4].median().item() for s in range(4)]
    share = (rel <= 1e-4).float().mean().item()
    q = torch.quantile(rel.double(), torch.tensor(
        [0.5, 0.9, 0.99, 0.999], dtype=torch.float64, device=dev)).tolist()
    log(f"f32 B2 at the {ev.name} evaluator's first tick ({n} problems): "
        f"max|dZ| {err:.3e}; per problem rel: median, p90, p99, p999 "
        f"{[f'{v:.3e}' for v in q]}, max {rel.max().item():.3e}; median by "
        f"problem mod 4 {[f'{v:.3e}' for v in slot_med]}; share <= 1e-4 "
        f"{share:.6f}; success {rk.success.float().mean().item():.6f} "
        f"(plain {rp.success.float().mean().item():.6f})")
    check(max(slot_med) <= 1e-4, f"f32 B2 = plain at the {ev.name} "
          f"evaluator's shape: median rel <= 1e-4 on each of the problems "
          f"mod 4")
    if f32_share is not None:
        check(share >= f32_share, f"f32 B2 = plain at the {ev.name} "
              f"evaluator's shape: share of problems with rel <= 1e-4 "
              f"{share:.6f} >= {f32_share}")
    k_ms, k_all = cuda_time_ms(lambda: fs(P, x, Z), reps=10)
    log(f"[{card}] B2 per {ev.name} evaluator tick ({n} problems, "
        f"T={ROLLOUT_N + 1}, f32): {k_ms:.3f} ms (median of 10; "
        f"{spread(k_all)}), plain fused_fleet_reference {p_ms:.1f} ms; B2's "
        f"share of a tick {k_ms * ROLLOUT_TICKS / 1e3 / float(np.median(wall)):.3f}")
    lin, merit, ip_iter = ev.counts
    return dict(launches=got["sqp_fused"], err=err, ms=k_ms, plain_ms=p_ms,
                episodes_per_s=eps,
                flops=roofline.sqp_flops(n, _phases_of(rollout.config),
                                         lin=lin, merit=merit,
                                         ip_iter=ip_iter),
                n_bytes=roofline.tensor_bytes(
                    torch.cat([P, P[:, -1:]], dim=1), x, Z, Z) + 8 * n)


def triggered_phase(dev, card, reset_counts, counts, none, ev):
    """The multi-robot evaluator at ``ev``'s shape with event-triggered
    communication (``comm="triggered"``): one B2 launch per tick and
    nothing else, the counts set to 0 before the run; success >= 0.9; the
    realized broadcast rate ``comm_rate`` strictly between 0 and 1."""
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.rollout import (
        make_multirobot_rollout)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_rollout import (  # noqa: E501
        read_metrics, throughput)

    rollout, _ = make_multirobot_rollout(
        n_robots=ev.planners, N=ROLLOUT_N, n_ticks=ROLLOUT_TICKS,
        dtype=torch.float32, device=dev, comm="triggered")
    reset_counts()
    read_metrics(rollout(*ev.scenes(ev.batch, 0)))
    got = counts()
    check(got == {**none, "sqp_fused": ROLLOUT_TICKS}, f"triggered "
          f"multi-robot evaluator: launches {got} (want {ROLLOUT_TICKS} B2)")
    m, wall = throughput(ev, rollout, seeds=(1,))
    summary = ev.summary(m)
    log(f"[{card}] multirobot evaluator, comm='triggered' (B={ev.batch} x "
        f"{ev.planners}, {ROLLOUT_TICKS} ticks, f32): "
        f"{ev.batch / wall[0]:.1f} episodes/s; {summary}")
    check(summary["solve_success"] >= 0.9, f"triggered multi-robot solve "
          f"success {summary['solve_success']:.4f} >= 0.9")
    check(0.0 < summary["comm_rate"] < 1.0, f"triggered multi-robot "
          f"comm_rate {summary['comm_rate']:.4f} in (0, 1)")
    return summary


# ---------------------------------------------------------------------------
# BASELINE configs 3 (CC-MPC) and 5 (SH-MPC)
# ---------------------------------------------------------------------------
#: tools/bench_matrix.py's fleets (B=512 plans, N=20, its 2x3+2x5+2x8
#: Gershgorin operating point, f32) and BASELINE config 3's own size
#: (``BASELINE.json`` ``configs[2]``: 256 planner instances, 6 Gaussian
#: obstacles).
MATRIX_B, CONFIG3_B, CONFIG3_OBS = 512, 256, 6
#: The SH-MPC tick: serial ticks under Gershgorin (B2), then ticks under
#: "mirror" (B1 at (6, 2) once per SQP iteration).
SH_TICKS, SH_MIRROR_TICKS = 60, 30
#: Pedestrians crossing the SH-MPC tick's straight 20 m path: start (x, y)
#: and velocity (vx, vy), m and m/s.
SH_PEDESTRIANS = [((5.0, 2.0), (0.0, -0.4)), ((10.0, -2.2), (0.0, 0.4))]


def matrix_phase(dev, card, reset_counts, counts, none):
    """tools/bench_matrix.py on the card: its five configurations (goal,
    contour, CC-MPC, T-MPC++, SH-MPC) at B=512 through B2 (``"fused"``),
    one launch each, the launch counts set to 0 before each; ms, plans/s,
    success and rows printed as the tool's JSON line. Returns the tool's
    inputs by name."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    cases = bench_matrix.cases(N_MAIN, MATRIX_B)
    results = {"batch": MATRIX_B, "horizon": N_MAIN, "card": card}
    for name, (ocp, *arrays) in cases.items():
        reset_counts()
        r, _, _ = bench_matrix.run_case(ocp, arrays, "fused", dev, MATRIX_B)
        got = counts()
        check(got["sqp_fused"] >= 1 and got == {**none, "sqp_fused":
                                                got["sqp_fused"]},
              f"bench_matrix {name}: B2 launches only ({got})")
        results.update({f"{name}_{k}": v for k, v in r.items()})
    log(f"[{card}] bench_matrix: {json.dumps(results)}")
    return cases


def fleet_flavour_phase(dev, card, reset_counts, counts, none, name, ocp,
                        arrays, consts, b1=True):
    """One BASELINE fleet (numpy ``arrays`` P, x0, z0 of ``ocp``) at
    tools/bench_matrix.py's operating point, f32: through B2
    (``"fused"``, one launch) and, with ``b1``, through B1 (``"pallas"``,
    one launch per SQP iteration), each run with the launch counts set to 0
    before it; success of each. Then B2 against its plain version on every
    problem (f64 within FUSED_F64_GATE per problem with the same success
    mask; f32 median rel <= 1e-4 on each warp slot), B1 on the fleet's first
    QPs against its plain version (f64 within QP_F64_GATE (1 + max|ref|),
    f32 median rel <= 1e-4), and their times; the hand count of an IP
    iteration at the fleet's rows is the roofline constant its bounds use.
    ``consts``: the roofline prefix of the OCP's operation counts. Returns
    B2's (and B1's) kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _make_machinery, _phases_of, make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_matrix import (  # noqa: E501
        matrix_config)

    cfg = matrix_config()
    n = arrays[0].shape[0]
    a32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in arrays)
    ip_iter, lin, merit = (getattr(roofline, f"{consts}_{kind}_FLOPS")
                           for kind in ("IP_ITER", "LIN", "MERIT"))
    backends = ("fused", "pallas") if b1 else ("fused",)
    want = {"fused": {**none, "sqp_fused": 1},
            "pallas": {**none, "qp_ip": cfg.n_sqp}}
    launches, fleets, success = {}, {}, {}
    for backend in backends:
        fleet = fleets[backend] = make_fleet_sqp_solver(
            ocp, cfg, dtype=torch.float32, device=dev, backend=backend)
        reset_counts()
        out = fleet(*a32)
        sync()
        launches[backend] = got = counts()
        check(got == want[backend], f"{name} fleet ({n} problems, nx="
              f"{ocp.nx}, m={len(ocp.ineq_row_spec())}) through {backend!r}:"
              f" launches {got} (want {want[backend]})")
        success[backend] = out.success.float().mean().item()
        check(bool(torch.isfinite(out.z).all()),
              f"{name} fleet through {backend!r}: finite iterates")
    fs = fleets["fused"]

    # B2 against its plain version: f64 every problem, f32 by warp slot
    fs64 = make_fleet_sqp_solver(ocp, cfg, dtype=torch.float64, device=dev,
                                 backend="fused")
    a64 = tuple(a.double() for a in a32)
    r_k, r_p = fs64(*a64), fs64.reference(*a64)
    sync()
    rel64 = ((r_k.z - r_p.z).abs().amax(dim=(1, 2))
             / (1.0 + r_p.z.abs().amax(dim=(1, 2))))
    log(f"f64 B2 on the {name} fleet ({n} problems): max|dZ| "
        f"{(r_k.z - r_p.z).abs().max().item():.3e}, max rel "
        f"{rel64.max().item():.3e}, success "
        f"{r_k.success.float().mean().item():.6f} (plain "
        f"{r_p.success.float().mean().item():.6f})")
    check(bool((r_k.success == r_p.success).all())
          and rel64.max().item() <= FUSED_F64_GATE, f"f64 B2 = plain on the "
          f"{name} fleet: same success, every problem max|dZ| / (1 + max|Z|)"
          f" <= {FUSED_F64_GATE:g}")
    del fs64, a64, r_k, r_p
    plain = {}
    rk = fs(*a32)
    fp_ms, _ = cuda_time_ms(lambda: plain.update(r=fs.reference(*a32)),
                            reps=1, warmup=0)
    rp = plain["r"]
    err = (rk.z - rp.z).abs().max().item()
    rel = ((rk.z - rp.z).abs().amax(dim=(1, 2))
           / (1.0 + rp.z.abs().amax(dim=(1, 2))))
    slot_med = [rel[s::4].median().item() for s in range(4)]
    log(f"f32 B2 on the {name} fleet: max|dZ| {err:.3e}, median rel by "
        f"problem mod 4 {[f'{v:.3e}' for v in slot_med]}, share <= 1e-4 "
        f"{(rel <= 1e-4).float().mean().item():.6f}; success "
        f"{rk.success.float().mean().item():.6f} (plain "
        f"{rp.success.float().mean().item():.6f})")
    check(max(slot_med) <= 1e-4, f"f32 B2 = plain on the {name} fleet: "
          f"median rel <= 1e-4 on each of the problems mod 4")
    f_ms, f_all = cuda_time_ms(lambda: fs(*a32), reps=10)
    log(f"[{card}] B2 on the {name} fleet ({n} problems, T="
        f"{arrays[0].shape[1] + 1}, "
        f"f32): {f_ms:.3f} ms per launch (median of 10; {spread(f_all)}) = "
        f"{n / f_ms * 1e3:.0f} plans/s, success {success['fused']:.4f}; "
        f"plain fused_fleet_reference {fp_ms:.1f} ms")
    P_t = torch.cat([a32[0], a32[0][:, -1:]], dim=1)
    entries = {"b2": dict(
        launches=launches["fused"]["sqp_fused"], err=err, ms=f_ms,
        plain_ms=fp_ms,
        flops=roofline.sqp_flops(n, _phases_of(cfg), lin=lin, merit=merit,
                                 ip_iter=ip_iter),
        n_bytes=roofline.tensor_bytes(P_t, a32[1], a32[2], a32[2]) + 8 * n)}
    if not b1:
        check_ip_count(fs.machinery, ocp, consts, f"the {name} fleet")
        return entries
    log(f"[{card}] {name} fleet through 'pallas' (B1 at ({ocp.nx}, "
        f"{ocp.nu}) per SQP iteration): success {success['pallas']:.4f}")

    # B1 at the fleet's first QPs (linearized at z0)
    for dtype in (torch.float64, torch.float32):
        mach = _make_machinery(ocp, cfg, dtype, dev)
        ins = tuple(a.to(dtype) for a in a32)
        qp = mach.build_qp(ins[2], torch.cat([ins[0], ins[0][:, -1:]], 1),
                           ins[1])
        kw = dict(nu=ocp.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
                  row_meta=mach.row_meta)
        qa = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask,
              qp.r0)
        dz_k = qp_cuda.solve_qp_batched(*qa, **kw)
        dz_p = qp_cuda.ip_solve_reference(*qa, **kw)
        sync()
        b1_err = (dz_k - dz_p).abs().max().item()
        scale = 1.0 + dz_p.abs().max().item()
        b1_rel = ((dz_k - dz_p).abs().amax(dim=(1, 2))
                  / (1.0 + dz_p.abs().amax(dim=(1, 2))))
        log(f"{str(dtype)[6:]} B1 ({ocp.nx}, {ocp.nu}) at the {name} "
            f"fleet's QPs ({n} problems, m={qp.D.shape[2]}, 8 iterations): "
            f"max|ddz| {b1_err:.3e}, max|dz| {scale - 1:.3e}, median rel "
            f"{b1_rel.median().item():.3e}")
        if dtype == torch.float64:
            check(b1_err <= QP_F64_GATE * scale, f"f64 B1 = plain at the "
                  f"{name} fleet's QPs: max|ddz| <= {QP_F64_GATE:g} "
                  f"(1 + max|dz|)")
        else:
            check(b1_rel.median().item() <= 1e-4, f"f32 B1 = plain at the "
                  f"{name} fleet's QPs: median rel <= 1e-4")
    k_ms, k_all = cuda_time_ms(lambda: qp_cuda.solve_qp_batched(*qa, **kw),
                               reps=20)
    p_ms, _ = cuda_time_ms(lambda: qp_cuda.ip_solve_reference(*qa, **kw),
                           reps=1, warmup=0)
    T, m = qp.g.shape[1], qp.D.shape[2]
    mh = sum(meta[0] == "h" for meta in mach.row_meta)
    check(roofline.ip_iter_flops(mach.row_meta, mach.stage_mask, ocp.nx,
                                 ocp.nu) == ip_iter,
          f"IP iteration count at the {name} fleet's rows and mask = "
          f"{consts}_IP_ITER_FLOPS {ip_iter}")
    log(f"[{card}] B1 ({ocp.nx}, {ocp.nu}) at the {name} fleet's QPs: "
        f"{k_ms:.3f} ms per launch of 8 iterations (median of 20; "
        f"{spread(k_all)}), plain {p_ms:.1f} ms")
    entries["b1"] = dict(
        launches=launches["pallas"]["qp_ip"], err=b1_err, ms=k_ms,
        plain_ms=p_ms, flops=roofline.ip_flops(n, 8, ip_iter=ip_iter),
        n_bytes=roofline.qp_bytes(T, ocp.nx, ocp.nu, m, mh, n, 4))
    return entries


def ccmpc_margin_phase(dev, card, evs):
    """The CC-MPC claim of the JAX package's tests/test_rollout.py: chance
    constraints keep larger obstacle margins than ellipsoids on the same
    scenes. At the evaluators' full width (4096 contouring scenes, 60
    ticks, f32): the mean of each episode's smallest obstacle distance is
    larger under CC-MPC; on the JAX test's scene (8 episodes, 2 crossing
    obstacles, N=10, 50 ticks, sigma_step 0.04, f64): success >= 0.99, no
    collision, progress > 12 m, and the smallest distance over the episodes
    larger by 0.05 m."""
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.rollout import (
        make_contouring_rollout)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_rollout import (  # noqa: E501
        read_metrics)

    full = {}
    for name in ("contouring", "ccmpc"):
        ev = evs[name]
        rollout, _ = ev.make(ROLLOUT_TICKS, torch.float32, dev)
        full[name] = read_metrics(rollout(*ev.scenes(ev.batch, 0)))
    mean_min = {k: float(np.mean(m["min_obstacle_dist"]))
                for k, m in full.items()}
    log(f"[{card}] min obstacle distance per episode, {evs['ccmpc'].batch} "
        f"contouring scenes (seed 0), f32: mean ellipsoid "
        f"{mean_min['contouring']:.4f} m, CC-MPC {mean_min['ccmpc']:.4f} m; "
        f"smallest {float(full['contouring']['min_obstacle_dist'].min()):.4f}"
        f" / {float(full['ccmpc']['min_obstacle_dist'].min()):.4f} m; "
        f"collision rate {float(np.mean(full['contouring']['collided'])):.4f}"
        f" / {float(np.mean(full['ccmpc']['collided'])):.4f}")
    check(mean_min["ccmpc"] > mean_min["contouring"], "CC-MPC keeps a larger "
          "mean obstacle distance than ellipsoids on the same scenes")

    rng = np.random.default_rng(3)
    B, n_obs = 8, 2
    x0 = np.zeros((B, 5))
    x0[:, 3] = 0.8
    ox = rng.uniform(3.0, 10.0, (B, n_obs))
    oy = rng.uniform(-2.5, 2.5, (B, n_obs)) + 1.0
    obs0 = np.stack([ox, oy], axis=-1)
    vel = np.stack([rng.uniform(-0.1, 0.1, (B, n_obs)),
                    -np.sign(oy) * rng.uniform(0.3, 0.8, (B, n_obs))], axis=-1)
    mins = {}
    for cons in ("ellipsoid", "gaussian"):
        rollout, _ = make_contouring_rollout(
            n_obstacles=n_obs, N=10, n_ticks=50, dtype=torch.float64,
            device=dev, constraints=cons, risk=0.05, sigma_step=0.04)
        m = read_metrics(rollout(x0, obs0, vel))
        succ = float(np.mean(m["solve_success_rate"]))
        mins[cons] = float(np.min(m["min_obstacle_dist"]))
        log(f"the JAX test's CC-MPC scene, {cons} (8 episodes, N=10, 50 "
            f"ticks, f64, B2): success {succ:.4f}, collided "
            f"{bool(np.any(m['collided']))}, smallest progress "
            f"{float(np.min(m['progress'])):.3f} m, smallest obstacle "
            f"distance {mins[cons]:.4f} m")
        check(succ >= 0.99 and not np.any(m["collided"])
              and float(np.min(m["progress"])) > 12.0,
              f"{cons} on the JAX test's scene: success >= 0.99, no "
              f"collision, progress > 12 m")
    check(mins["gaussian"] > mins["ellipsoid"] + 0.05, "CC-MPC's smallest "
          "obstacle distance exceeds the ellipsoids' by 0.05 m on the JAX "
          "test's scene")
    return mean_min


def build_sh_planner(dev, regularization):
    """SH-MPC (``configuration_safe_horizon``) on ``dev`` at f32: N=20, 2
    obstacles, risk 0.1, 4 parallel solvers, the default sample count, 6 SQP
    iterations of 12 IP iterations; prewarmed."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        build_planner, configuration_safe_horizon, prewarm_planner)
    from oscar_mpc_planner_mr_modification_tpu_torch.modules import (
        ScenarioConstraintModule)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    settings = default_settings(
        N=N_MAIN, max_obstacles=len(SH_PEDESTRIANS),
        probabilistic={"enable": True, "risk": 0.1},
        scenario_constraints={"parallel_solvers": 4})
    model, modules = configuration_safe_horizon(settings)
    cfg = SQPConfig(n_sqp=6, n_qp_iter=12, mu_min=1e-6, w_max=1e6,
                    reg_eps=1e-4, regularization=regularization,
                    track_best=False)
    planner = build_planner(model, modules, settings, dtype=torch.float32,
                            sqp_config=cfg, device=dev)
    opt = next(m for m in planner.modules
               if isinstance(m, ScenarioConstraintModule))._optimizer
    t = time.perf_counter()
    prewarm_planner(planner, model, settings)
    log(f"SH-MPC planner ({regularization}) built and prewarmed in "
        f"{time.perf_counter() - t:.2f} s")
    return planner, model, settings, opt


def run_sh_ticks(planner, model, settings, opt, n_ticks, capture_at=None):
    """``n_ticks`` serial SH-MPC ticks on a straight 20 m path crossed by
    SH_PEDESTRIANS (constant-velocity Gaussian predictions, new samples
    every tick); the robot advances by the model's dynamics at f64. Returns
    per-tick records (success, ms, support, certificate, uncovered,
    clearance to the pedestrians' mean positions) and, at tick
    ``capture_at``, the batched solve's inputs."""
    from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E501
        define_robot_area, ensure_obstacle_size,
        get_constant_velocity_prediction)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
    from oscar_mpc_planner_mr_modification_tpu_torch.types import (
        DynamicObstacle, RealTimeData)

    N, dt = planner.solver.N, planner.solver.dt
    r_robot = float(settings["robot_radius"])
    iv = model.state_index("v")
    state = State(model)
    state.set("v", 0.8)
    captured = {}
    solve = opt._solve_batch

    def spy(params, xinit, warm):
        captured["in"] = (params.copy(), np.asarray(xinit).copy(),
                          warm.copy())
        return solve(params, xinit, warm)

    records = []
    for k in range(n_ticks):
        data = RealTimeData()
        data.robot_area = define_robot_area(0.65, 0.65, 1)
        data.reference_path.x = list(np.linspace(0.0, 20.0, 25))
        data.reference_path.y = [0.0] * 25
        peds = []
        for i, (p0, v) in enumerate(SH_PEDESTRIANS):
            pos = np.asarray(p0) + k * dt * np.asarray(v)
            obs = DynamicObstacle(index=i, position=pos, radius=0.3)
            obs.prediction = get_constant_velocity_prediction(
                pos, np.asarray(v), dt, N, probabilistic=True)
            peds.append(obs)
        data.dynamic_obstacles = ensure_obstacle_size(
            peds, state, settings["max_obstacles"], N, dt,
            probabilistic=True)
        if k == 0:
            planner.on_data_received(data, "reference_path")
        planner.on_data_received(data, "dynamic obstacles")
        opt._solve_batch = spy if k == capture_at else solve
        sync()
        t0 = time.perf_counter()
        out = planner.solve_mpc(state, data)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        opt._solve_batch = solve
        a = planner.get_solution(0, "a") if out.success else -3.0
        w = planner.get_solution(0, "w") if out.success else 0.0
        x = model.discrete_dynamics(torch.as_tensor(state.as_array()),
                                    torch.tensor([a, w], dtype=torch.float64),
                                    dt).numpy()
        x[iv] = max(x[iv], 0.0)
        state.set_array(x)
        clear = min(np.linalg.norm(state.get_position() - (
            np.asarray(p0) + (k + 1) * dt * np.asarray(v))) - r_robot - 0.3
            for p0, v in SH_PEDESTRIANS)
        records.append(dict(success=bool(out.success), ms=ms,
                            support=opt.last_support,
                            certificate=opt.last_certificate,
                            uncovered=opt.last_uncovered, clearance=clear))
    return records, captured.get("in"), state


def shmpc_tick_phase(dev, card, reset_counts, counts, none):
    """(d) The SH-MPC planner tick on the card: ``configuration_safe_horizon``
    and ``build_planner`` at f32, 4 parallel scenario solvers; SH_TICKS
    serial ticks under Gershgorin, the launch counts set to 0 before them:
    one B2 launch (4 problems) per tick and nothing else, the fused backend,
    success on >= 90% of ticks, no contact with the pedestrians' mean
    positions, progress; B2 at the tick's shape against its plain version
    (f64 within FUSED_F64_GATE, same success) and timed. Then (m3)
    SH_MIRROR_TICKS ticks under "mirror": the ``"lanes"`` backend, per
    tick one mirror linearize launch and one B1 (6, 2) field launch per SQP
    iteration and one merit launch, nothing else; success on >= 90% of
    ticks without contact, the median, p99 and spikes against 44 ms and
    against the Gershgorin ticks' median; and B1's field entry at that
    tick's QPs against its plain version. Returns the kernel entry numbers
    of B2 and B1 in the tick."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _phases_of, make_fleet_sqp_solver)

    def summary(name, recs, state):
        ms = [r["ms"] for r in recs]
        log(f"[{card}] SH-MPC tick, {name} ({len(recs)} ticks, N={N_MAIN}, "
            f"4 solvers x {opt.n_samples} samples, f32): success "
            f"{np.mean([r['success'] for r in recs]):.4f}, tick "
            f"{np.median(ms):.2f} ms median (min {min(ms):.2f}, max "
            f"{max(ms):.2f}), smallest clearance "
            f"{min(r['clearance'] for r in recs):.4f} m, support "
            f"{sorted({r['support'] for r in recs})}, certificate "
            f"{min(r['certificate'] for r in recs):.4f}-"
            f"{max(r['certificate'] for r in recs):.4f}, under-covered cells "
            f"{max(r['uncovered'] for r in recs)}, progress "
            f"{state.get('x'):.3f} m")
        for k in sorted({0, len(recs) // 2, len(recs) - 1}):
            log(f"SH-MPC {name} tick {k}: {recs[k]}")

    planner, model, settings, opt = build_sh_planner(dev, "gershgorin")
    check(opt.fleet_backend == "fused", f"SH-MPC backend under Gershgorin "
          f"{opt.fleet_backend!r} == 'fused'")
    reset_counts()
    recs, captured, state = run_sh_ticks(planner, model, settings, opt,
                                         SH_TICKS, capture_at=SH_TICKS // 2)
    recs_g = recs
    got = counts()
    check(got == {**none, "sqp_fused": SH_TICKS}, f"SH-MPC ticks: launches "
          f"{got} (want one B2 launch per tick, {SH_TICKS}, and nothing "
          f"else)")
    summary("Gershgorin, B2", recs, state)
    check(np.mean([r["success"] for r in recs]) >= 0.9,
          "SH-MPC ticks succeed on >= 90% of ticks")
    check(min(r["clearance"] for r in recs) > 0.0, "SH-MPC ticks: no "
          "contact with the pedestrians' mean positions")
    check(state.get("x") > 5.0, f"SH-MPC ticks: progress "
          f"{state.get('x'):.3f} m > 5 m")

    # B2 at the tick's shape (4 problems): f64 against plain, f32 timed
    ocp, cfg = planner.solver.ocp, planner.solver.config
    params, xinit, warm = captured
    P = params.shape[0]
    fs64 = make_fleet_sqp_solver(ocp, cfg, dtype=torch.float64, device=dev,
                                 backend="fused")
    a64 = (torch.as_tensor(params, device=dev),
           torch.as_tensor(xinit, device=dev)[None].expand(P, -1).contiguous(),
           torch.as_tensor(warm, device=dev))
    r_k, r_p = fs64(*a64), fs64.reference(*a64)
    sync()
    rel = ((r_k.z - r_p.z).abs().amax(dim=(1, 2))
           / (1.0 + r_p.z.abs().amax(dim=(1, 2))))
    log(f"f64 B2 at the SH-MPC tick's shape ({P} problems, m=40): max|dZ| "
        f"{(r_k.z - r_p.z).abs().max().item():.3e}, max rel "
        f"{rel.max().item():.3e}, success {r_k.success.tolist()}")
    check(bool((r_k.success == r_p.success).all())
          and rel.max().item() <= FUSED_F64_GATE, f"f64 B2 = plain at the "
          f"SH-MPC tick: same success, max|dZ| / (1 + max|Z|) <= "
          f"{FUSED_F64_GATE:g}")
    fs = make_fleet_sqp_solver(ocp, cfg, dtype=torch.float32, device=dev,
                               backend="fused")
    a32 = tuple(a.float() for a in a64)
    plain = {}
    rk = fs(*a32)
    p_ms, _ = cuda_time_ms(lambda: plain.update(r=fs.reference(*a32)),
                           reps=1, warmup=0)
    err = (rk.z - plain["r"].z).abs().max().item()
    k_ms, k_all = cuda_time_ms(lambda: fs(*a32), reps=20)
    log(f"[{card}] B2 at the SH-MPC tick ({P} problems, f32): {k_ms:.3f} ms"
        f" (median of 20; {spread(k_all)}), plain {p_ms:.1f} ms; f32 max|dZ|"
        f" vs plain {err:.3e}")
    b2 = dict(launches=got["sqp_fused"], err=err, ms=k_ms, plain_ms=p_ms,
              flops=roofline.sqp_flops(
                  P, _phases_of(cfg), lin=roofline.SHMPC_LIN_FLOPS,
                  merit=roofline.SHMPC_MERIT_FLOPS,
                  ip_iter=roofline.SHMPC_IP_ITER_FLOPS),
              n_bytes=roofline.tensor_bytes(
                  torch.cat([a32[0], a32[0][:, -1:]], dim=1), a32[1],
                  a32[2], a32[2]) + 8 * P)
    del planner

    # (m3) "mirror": the lane path, the mirror linearize entry and B1's
    # field entry at (6, 2) once per SQP iteration each
    planner, model, settings, opt = build_sh_planner(dev, "mirror")
    check(opt.fleet_backend == "lanes", f"SH-MPC backend under 'mirror' "
          f"{opt.fleet_backend!r} == 'lanes'")
    reset_counts()
    recs, captured, state = run_sh_ticks(planner, model, settings, opt,
                                         SH_MIRROR_TICKS, capture_at=1)
    got = counts()
    n_sqp = planner.solver.config.n_sqp
    want = {**none, "linearize_mirror": n_sqp * SH_MIRROR_TICKS,
            "lanes": n_sqp * SH_MIRROR_TICKS, "merit": SH_MIRROR_TICKS}
    check(got == want, f"(m3) SH-MPC 'mirror' ticks: launches {got} (want "
          f"per tick {n_sqp} mirror linearize, {n_sqp} B1 field and 1 merit "
          f"launch, and nothing else)")
    summary("'mirror', mirror linearize + B1 (6, 2)", recs, state)
    check(np.mean([r["success"] for r in recs]) >= 0.9 and min(
        r["clearance"] for r in recs) > 0.0, "(m3) SH-MPC 'mirror' ticks "
          "succeed on >= 90% of ticks without contact")
    ms_m = tick_summary(card, "(m3) SH-MPC tick under 'mirror' (lanes)",
                        np.asarray([r["ms"] for r in recs[1:]]))
    ms_g = float(np.median([r["ms"] for r in recs_g]))
    log(f"[{card}] (m3) SH-MPC tick median: 'mirror' {ms_m:.3f} ms against "
        f"Gershgorin {ms_g:.3f} ms in this run ({ms_m / ms_g:.2f}x) and the "
        f"1.58 s of the 'pallas' path (PERF.md section 5)")
    ocp, cfg = planner.solver.ocp, planner.solver.config
    b1 = dict(lanes_b1_against_plain(dev, card, ocp, cfg, captured,
                                     "the SH-MPC 'mirror' tick"),
              launches=got["lanes"])
    b1["tick_ms"], b1["mirror_launches"] = ms_m, got["linearize_mirror"]
    lin = mirror_tick_lin(dev, card, ocp, cfg, captured,
                          "the SH-MPC 'mirror' tick",
                          roofline.SHMPC_LIN_MIRROR_FLOPS
                          + roofline.SHMPC_MERIT_FLOPS)
    return dict(b2=b2, b1=b1, lin=lin)


# ---------------------------------------------------------------------------
# The default regularization, "mirror", on the lane path: the mirror
# linearize entry (csrc/sqp_linearize_mirror.cu), then B1's field entry
# ---------------------------------------------------------------------------
#: (m1)'s fleets: the bench fleet (B_MAIN plans x 9 planners, T=21) and
#: tools/bench_matrix.py's SH-MPC (nz=8) and bicycle (nz=9) fleets of
#: MATRIX_B problems.
MIRROR_FLEETS = ("bench", "SH-MPC", "bicycle")
#: The stage and problem (m1) feeds a NaN cost weight.
MIRROR_NAN_STAGE, MIRROR_NAN_PROBLEM = 3, 7


def mirror_fleet(name, dtype, dev):
    """``(ocp, P (B, T, npar) with stage N repeating N-1, x0, Z)`` of one
    of MIRROR_FLEETS on ``dev``."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    if name == "bench":
        ocp, args = bench_fleet(B_MAIN, dtype, dev)
        P, x0, Z = flat_fleet(args)
        return ocp, fleet_P(P), x0, Z
    rng = np.random.default_rng(14)
    ocp, *arrays = (bench_matrix.build_shmpc(N_MAIN, MATRIX_B, rng)
                    if name == "SH-MPC" else
                    bench_matrix.build_bicycle(BICYCLE_N, MATRIX_B, rng))
    P, x0, Z = (torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays)
    return ocp, fleet_P(P), x0, Z


def mirror_against_plain(dev, name, ocp, cfg, lin, P, x0, Z, design,
                         nan_at):
    """The mirror entry in ``design`` ("warp", "block", or "batch": what
    the batch picks) at f64 against its plain version
    (``sqp_fused.linearize_reference``: ``torch.func`` and ``eigh``, on the
    card): every field within LIN_F64_RTOL / LIN_F64_ATOL; every body
    block's smallest eigenvalue at least reg_eps; one stage of one problem
    (``nan_at``: problem, stage) fed a NaN cost weight comes out with that
    stage's H block all NaN and every other output equal to the run
    without it. Returns the largest difference over the fields."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import QPData

    tables = lin.tables
    ins = sqp_fused._lanes_in(P, x0, Z)
    B = Z.shape[0]
    qp, mo = sqp_fused.linearize_fields(tables, *ins, mapping=design)
    got = sqp_fused.unpack_qp(qp, tables)
    want = sqp_fused.linearize_reference(lin.machinery, tables, P, x0, Z)
    sync()
    worst, err = [], 0.0
    for field, a, b in zip(QPData._fields + ("merit", "cost", "eq_res"),
                           (*got, mo[0], mo[1], mo[2]),
                           (*want[0], *want[1:])):
        d = (a - b).abs().max().item()
        err = max(err, d)
        if not torch.allclose(a, b, rtol=LIN_F64_RTOL, atol=LIN_F64_ATOL):
            worst.append(field)
        if field == "H":
            log(f"f64 {name} mirror linearize ({B} problems, {design}): H "
                f"max|d| {d:.3e}, max|ref| {b.abs().max().item():.3e}")
    log(f"f64 {name} mirror linearize ({B} problems, T={tables.T}, "
        f"nz={tables.nx + tables.nu}, {design}): max|d| {err:.3e} over "
        f"every field")
    check(not worst, f"f64 {name} ({design}): mirror linearize entry = "
          f"build_qp under 'mirror' on every field within rtol "
          f"{LIN_F64_RTOL:g}, atol {LIN_F64_ATOL:g} (failed: {worst})")
    H = got.H
    # on the host: cuSOLVER refuses the bench's 92160 blocks
    w_min = torch.linalg.eigvalsh(H[:, :-1].cpu()).min().item()
    check(w_min >= cfg.reg_eps * (1 - 1e-9), f"f64 {name} ({design}): every "
          f"body block's smallest eigenvalue {w_min:.6e} >= reg_eps "
          f"{cfg.reg_eps:g}")
    b, t = nan_at
    Pn = P.clone()
    Pn[b, t, ocp.registry.index("acceleration")] = float("nan")
    qn, mn = sqp_fused.linearize_fields(
        tables, *sqp_fused._lanes_in(Pn, x0, Z), mapping=design)
    Hn = sqp_fused.unpack_qp(qn, tables).H
    sync()
    rest = Hn.clone()
    rest[b, t] = H[b, t]
    others = torch.ones(B, dtype=torch.bool, device=dev)
    others[b] = False
    check(bool(torch.isnan(Hn[b, t]).all()) and torch.equal(rest, H)
          and torch.equal(qn[:, others], qp[:, others])
          and torch.equal(mn[:, others], mo[:, others]),
          f"f64 {name} ({design}): a NaN cost weight at stage {t} of "
          f"problem {b} makes that stage's H block all NaN, and no other H "
          f"block and no other problem changes")
    return err


def mirror_times(card, name, ocp, cfg, lin, P, x0, Z, dtype, reps):
    """Times per launch of the mirror entry in both designs and in the one
    the batch picks, of the Gershgorin linearize entry on the same inputs
    and of the plain version; the designs' plans logged. Returns the
    numbers of the picked design."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused

    tables = lin.tables
    g_tables = sqp_fused.ocp_tables(ocp, cfg._replace(
        regularization="gershgorin"))
    ins = sqp_fused._lanes_in(P, x0, Z)
    B = Z.shape[0]
    ms = {}
    for design in ("batch", "warp", "block"):
        ms[design], all_ms = cuda_time_ms(lambda: sqp_fused.linearize_fields(
            tables, *ins, mapping=design), reps=reps)
        plan = sqp_fused.mirror_plan(dtype, tables, B, design)
        log(f"[{card}] {name} mirror entry ({B} problems, T={tables.T}, "
            f"nz={tables.nx + tables.nu}, {str(dtype)[6:]}), {design}: "
            f"{ms[design]:.3f} ms per launch ({spread(all_ms)}); plan {plan}")
    g_ms, g_all = cuda_time_ms(
        lambda: sqp_fused.linearize_fields(g_tables, *ins), reps=reps)
    p_ms, _ = cuda_time_ms(
        lambda: sqp_fused.linearize_reference(lin.machinery, tables, P, x0,
                                              Z), reps=1, warmup=1)
    picked = sqp_fused.mirror_plan(dtype, tables, B)["design"]
    log(f"[{card}] {name} linearize entries ({B} problems, "
        f"{str(dtype)[6:]}): mirror {ms['batch']:.3f} ms ({picked}; warp "
        f"{ms['warp']:.3f}, block {ms['block']:.3f}), Gershgorin "
        f"{g_ms:.3f} ms ({spread(g_all)}), ratio {ms['batch'] / g_ms:.3f}; "
        f"plain (torch.func + eigh) {p_ms:.1f} ms")
    return dict(ms=ms["batch"], plain_ms=p_ms, gershgorin_ms=g_ms,
                design=picked, warp_ms=ms["warp"], block_ms=ms["block"])


def mirror_lin_phase(dev, card):
    """(m1) The mirror linearize entry against its plain version at f64 on
    MIRROR_FLEETS in both designs (``mirror_against_plain``), and its times
    per launch, f64 and f32, in both designs beside the Gershgorin
    linearize entry's on the same inputs, and the plain version's. Returns,
    per fleet, the numbers of the design its batch picks (f32 times)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        roofline, sqp_fused)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.linearize import (
        make_lane_linearizer)

    cfg = bench_config()._replace(regularization="mirror")
    out = {}
    for name in MIRROR_FLEETS:
        res = {}
        for dtype in (torch.float64, torch.float32):
            ocp, P, x0, Z = mirror_fleet(name, dtype, dev)
            lin = make_lane_linearizer(ocp, cfg, dtype=dtype, device=dev)
            tables = lin.tables
            check(tables.reg == sqp_fused.REG_MIRROR,
                  f"{name}: the lane linearizer's tables say REG_MIRROR")
            B = Z.shape[0]
            if dtype == torch.float64:
                res["err"] = max(mirror_against_plain(
                    dev, name, ocp, cfg, lin, P, x0, Z, design,
                    (MIRROR_NAN_PROBLEM, MIRROR_NAN_STAGE))
                    for design in ("warp", "block"))
            t = mirror_times(card, name, ocp, cfg, lin, P, x0, Z, dtype,
                             10 if name == "bench" else 20)
            if dtype == torch.float32:
                per = {"bench": roofline.LIN_MIRROR_FLOPS,
                       "SH-MPC": roofline.SHMPC_LIN_MIRROR_FLOPS,
                       "bicycle": roofline.BICYCLE_LIN_MIRROR_FLOPS}[name]
                merit = {"bench": roofline.MERIT_FLOPS,
                         "SH-MPC": roofline.SHMPC_MERIT_FLOPS,
                         "bicycle": roofline.BICYCLE_MERIT_FLOPS}[name]
                res.update(t, flops=(per + merit) * B,
                           n_bytes=mirror_bytes(tables, P, x0, Z))
        out[name] = res
    return out


def mirror_bytes(tables, P, x0, Z):
    """Bytes the mirror entry must move: its inputs once, its QP buffer and
    merit terms once."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        roofline, sqp_fused)

    n_out = sqp_fused.qp_layout(tables.T, tables.m, tables.mh, tables.nx,
                                tables.nu)["total"] + 3
    return (roofline.tensor_bytes(*sqp_fused._lanes_in(P, x0, Z))
            + Z.element_size() * Z.shape[0] * n_out)


def mirror_tick_lin(dev, card, ocp, cfg, captured, name, flops):
    """(m1) at a tick's problems: the dispatch ``captured`` in (m2) or
    (m3) linearized by the mirror entry at f64 in the design its batch
    picks (and the other) against the plain version (``mirror_against_
    plain``, the NaN stage at problem 0, stage 3), then timed at f32 and
    f64 beside the Gershgorin entry. Returns the entry's numbers at f32
    (``flops``: operations per problem)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.linearize import (
        make_lane_linearizer)

    params, xinit, warm = captured
    res = {}
    for dtype in (torch.float64, torch.float32):
        lin = make_lane_linearizer(ocp, cfg, dtype=dtype, device=dev)
        Pt = torch.as_tensor(params, dtype=dtype, device=dev)
        Pt = torch.cat([Pt, Pt[:, -1:]], dim=1)
        x0 = torch.as_tensor(xinit, dtype=dtype, device=dev)[None].expand(
            Pt.shape[0], -1).contiguous()
        Z = torch.as_tensor(warm, dtype=dtype, device=dev)
        if dtype == torch.float64:
            res["err"] = max(mirror_against_plain(
                dev, name, ocp, cfg, lin, Pt, x0, Z, design,
                (0, MIRROR_NAN_STAGE)) for design in ("batch", "warp"))
        t = mirror_times(card, name, ocp, cfg, lin, Pt, x0, Z, dtype, 20)
        if dtype == torch.float32:
            res.update(t, flops=flops * Z.shape[0],
                       n_bytes=mirror_bytes(lin.tables, Pt, x0, Z))
    check(res["design"] == "block", f"{name}: the mirror entry runs the "
          f"block design at the tick's {Z.shape[0]} problems")
    return res


#: (m2)'s ticks through the "pallas" backend (the picture before this
#: path): that tick runs torch.func and eigh per SQP iteration.
PALLAS_TICKS = 6


def lanes_b1_against_plain(dev, card, ocp, cfg, captured, name):
    """B1's field entry at a tick's shape under "mirror": the captured
    dispatch's problems linearized by the mirror entry, then B1 at f64
    against its plain version (QP_F64_GATE) and at f32 timed beside it.
    Returns its kernel entry's numbers (f32)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.linearize import (
        make_lane_linearizer)

    params, xinit, warm = captured
    P = params.shape[0]
    for dtype in (torch.float64, torch.float32):
        lin = make_lane_linearizer(ocp, cfg, dtype=dtype, device=dev)
        Pt = torch.as_tensor(params, dtype=dtype, device=dev)
        Pt = torch.cat([Pt, Pt[:, -1:]], dim=1)
        x0 = torch.as_tensor(xinit, dtype=dtype, device=dev)[None].expand(
            P, -1)
        Z = torch.as_tensor(warm, dtype=dtype, device=dev)
        fields, _ = lin.fields(Pt.permute(2, 1, 0).contiguous(),
                               Z.permute(1, 2, 0).contiguous(),
                               x0.t().contiguous())
        kw = dict(nu=ocp.nu, n_iters=cfg.n_qp_iter, mu_min=cfg.mu_min,
                  w_max=cfg.w_max, row_meta=lin.machinery.row_meta)
        mask = lin.machinery.stage_mask
        zk = qp_cuda.solve_qp_fields(fields, mask, **kw)
        zp = qp_cuda.fields_reference(fields, mask, **kw)
        sync()
        err = (zk - zp).abs().max().item()
        scale = 1.0 + zp.abs().max().item()
        log(f"{str(dtype)[6:]} B1 field entry at {name} ({P} problems, "
            f"{cfg.n_qp_iter} iterations, the mirror entry's QPs): max|d| "
            f"{err:.3e}, max|ref| {scale - 1:.3e}")
        if dtype == torch.float64:
            check(err <= QP_F64_GATE * scale, f"f64 B1 field entry = plain "
                  f"at {name}: max|d| <= {QP_F64_GATE:g} (1 + max|ref|)")
    k_ms, k_all = cuda_time_ms(lambda: qp_cuda.solve_qp_fields(
        fields, mask, **kw), reps=20)
    p_ms, _ = cuda_time_ms(lambda: qp_cuda.fields_reference(
        fields, mask, **kw), reps=1, warmup=0)
    m_ms, _ = cuda_time_ms(lambda: lin.fields(
        Pt.permute(2, 1, 0).contiguous(), Z.permute(1, 2, 0).contiguous(),
        x0.t().contiguous()), reps=20)
    log(f"[{card}] at {name} ({P} problems, f32): B1 field entry "
        f"{k_ms:.3f} ms per launch ({cfg.n_qp_iter} iterations; "
        f"{spread(k_all)}), plain {p_ms:.1f} ms; the mirror linearize entry "
        f"{m_ms:.3f} ms per launch")
    mh = sum(meta[0] == "h" for meta in lin.machinery.row_meta)
    ip_iter = roofline.ip_iter_flops(lin.machinery.row_meta, mask, ocp.nx,
                                     ocp.nu)
    return dict(err=err, ms=k_ms, plain_ms=p_ms, mirror_ms=m_ms,
                flops=roofline.ip_flops(P, cfg.n_qp_iter, ip_iter=ip_iter),
                n_bytes=roofline.qp_bytes(Z.shape[1], ocp.nx, ocp.nu,
                                          len(mask[0]), mh, P, 4))


def tick_summary(card, name, t_ms):
    """Median, p99 and spike share of a run's tick times, logged beside
    the 44 ms budget; returns the median."""
    med = float(np.median(t_ms))
    log(f"[{card}] {name}: {len(t_ms)} timed ticks, median {med:.3f} ms, "
        f"p99 {np.percentile(t_ms, 99):.3f} ms, max {t_ms.max():.3f} ms, "
        f"spike share (> 1.5x median) {np.mean(t_ms > 1.5 * med):.4f}, "
        f"within the 44 ms budget on {np.mean(t_ms <= 44.0):.4f} of ticks")
    return med


def mirror_tick_phase(dev, card, reset_counts, counts, none):
    """(m2) The T-MPC++ tick of tools/common.py's scene with the planner
    built from the settings (``sqp_config=None``: 10 SQP x 18 IP
    iterations under "mirror"), serial: the ``"lanes"`` backend, per tick
    n_sqp launches of the mirror linearize entry, n_sqp of B1's field entry
    and one merit launch, no B2, no S1, no torch.func; success, progress,
    no contact; median, p99 and spikes against 44 ms. Then the same tick
    through ``"pallas"`` (torch.func and eigh per SQP iteration, B1
    batch-major), PALLAS_TICKS ticks, with its median; and the lane and
    pallas fleet solves at f64 on one captured tick's inputs: the same
    success and winner, every problem within FUSED_F64_GATE. Then B1's
    field entry at the tick's shape against its plain version. Returns the
    kernel entries' numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        make_fleet_sqp_solver)

    t = time.perf_counter()
    scene = tick_scene(dev, torch.float32, N_MAIN, from_settings=True)
    log(f"settings-built tick planner built and prewarmed in "
        f"{time.perf_counter() - t:.2f} s")
    planner, opt = scene.planner, scene.optimizer
    cfg = planner.solver.config
    check((cfg.regularization, cfg.n_sqp, cfg.n_qp_iter, cfg.n_qp_iter_warm)
          == ("mirror", 10, 18, 0), f"settings-built config: "
          f"{cfg.regularization!r}, {cfg.n_sqp} x {cfg.n_qp_iter}, warm "
          f"{cfg.n_qp_iter_warm}")
    check(opt.fleet_backend == "lanes", f"settings-built tick fleet backend "
          f"{opt.fleet_backend!r} == 'lanes'")
    reset_counts()
    rec = run_ticks(scene, False, capture_at=TICKS // 3)
    got = counts()
    n = rec["ticks"]
    want = {**none, "linearize_mirror": cfg.n_sqp * n,
            "lanes": cfg.n_sqp * n, "merit": n}
    check(got == want, f"settings-built ticks: launches {got} (want per "
          f"tick {cfg.n_sqp} mirror linearize, {cfg.n_sqp} B1 field and 1 "
          f"merit launch, {n} ticks, and no other kernel)")
    share = rec["success"] / n
    check(share >= 0.95, f"settings-built ticks: success {rec['success']}/{n}"
          f" = {share:.4f} >= 0.95")
    check(rec["min_clearance"] > 0.0 and rec["progress_m"] >= 10.0,
          f"settings-built ticks: smallest clearance "
          f"{rec['min_clearance']:.4f} m > 0, progress "
          f"{rec['progress_m']:.3f} m >= 10 m")
    lanes_ms = tick_summary(card, "settings-built T-MPC++ tick ('mirror', "
                            "'lanes', 10 x 18, P=5, N=20, f32, serial)",
                            rec["tick_ms"])
    log(f"settings-built tick host-serial median "
        f"{np.median(rec['host_ms']):.3f} ms, fetch wait median "
        f"{np.median(rec['wait_ms']):.3f} ms")
    captured = rec["captured"]

    # the same tick through "pallas", the path before this one
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import tmpc

    opt.fleet_backend = "pallas"
    opt._packed_solve = {opt._fleet_n_full: tmpc.packed_fleet_solve(
        planner.solver, opt.n_planners, "pallas", opt._fleet_n_full)}
    reset_counts()
    rec_p = run_ticks(scene, False, n_ticks=PALLAS_TICKS)
    got_p = counts()
    check(got_p == {**none, "qp_ip": cfg.n_sqp * rec_p["ticks"]},
          f"'pallas' ticks: launches {got_p} (B1 batch-major once per SQP "
          f"iteration)")
    pallas_ms = tick_summary(card, "the same tick through 'pallas' "
                             "(torch.func + eigh, B1 batch-major)",
                             rec_p["tick_ms"])
    log(f"[{card}] settings-built tick: 'lanes' median {lanes_ms:.3f} ms "
        f"against 'pallas' {pallas_ms:.3f} ms in this run ("
        f"{pallas_ms / lanes_ms:.2f}x)")

    # winners at f64 on one tick's inputs, lanes against pallas
    params, xinit, warm = captured
    P = params.shape[0]
    a64 = (torch.as_tensor(params, dtype=torch.float64, device=dev),
           torch.as_tensor(xinit, dtype=torch.float64,
                           device=dev)[None].expand(P, -1).contiguous(),
           torch.as_tensor(warm, dtype=torch.float64, device=dev))
    ocp = planner.solver.ocp
    r = {b: make_fleet_sqp_solver(ocp, cfg, dtype=torch.float64, device=dev,
                                  backend=b)(*a64)
         for b in ("lanes", "pallas")}
    sync()
    rl, rp = r["lanes"], r["pallas"]
    rel = ((rl.z - rp.z).abs().amax(dim=(1, 2))
           / (1.0 + rp.z.abs().amax(dim=(1, 2))))

    def winner(res):
        cost = torch.where(res.success, res.cost,
                           torch.full_like(res.cost, float("inf")))
        return int(torch.argmin(cost))

    log(f"f64 settings-built tick's {P} problems, 'lanes' vs 'pallas': max "
        f"rel dZ {rel.max().item():.3e}, success {rl.success.tolist()} / "
        f"{rp.success.tolist()}, winners {winner(rl)} / {winner(rp)}")
    check(bool((rl.success == rp.success).all()) and winner(rl) == winner(rp)
          and rel.max().item() <= FUSED_F64_GATE, "f64 'lanes' = 'pallas' on "
          f"the tick's problems: same success and winner, max|dZ| / (1 + "
          f"max|Z|) <= {FUSED_F64_GATE:g}")
    b1 = lanes_b1_against_plain(dev, card, ocp, cfg, captured,
                                "the settings-built tick")
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline

    lin = mirror_tick_lin(dev, card, ocp, cfg, captured,
                          "the settings-built tick",
                          roofline.TICK_LIN_MIRROR_FLOPS
                          + roofline.TICK_MERIT_FLOPS)
    return dict(b1=dict(b1, launches=got["lanes"]), lin=lin,
                mirror_launches=got["linearize_mirror"],
                launches_per_tick=(got["linearize_mirror"] + got["lanes"]
                                   + got["merit"]) / n,
                ms=lanes_ms, pallas_ms=pallas_ms)


# ---------------------------------------------------------------------------
# The multi-robot driver, the dynamic velocity reference, the configuration
# sweep
# ---------------------------------------------------------------------------
#: The three-robot intersection of the JAX package's
#: tests/test_multirobot.py (namespace, start pose, goal) and the crossing
#: pedestrian of its examples/demo_multirobot.py (start, goal).
MR_ROBOTS = [("r1", (2.0, 0.0, 0.0), (10.0, 0.0)),
             ("r2", (10.0, 1.2, np.pi), (2.0, 1.2)),
             ("r3", (6.0, -4.0, np.pi / 2), (6.0, 4.0))]
MR_PEDESTRIAN = ((6.5, 5.0), (6.5, -6.0))
MR_CYCLES, MR_DESYNC_CYCLES = 60, 20
#: The robots' SQP: the JAX test's 5 x 10, with the kernel's regularization.
MR_CFG = dict(n_sqp=5, n_qp_iter=10, regularization="gershgorin")
DYNVREF_TICKS = 60
SWEEP_N, SWEEP_TICKS = 8, 3
#: The configurations of the JAX package's tests/test_config_sweep.py, all
#: nine of them on the card: name,
#: factory function, settings overrides, and whether the planner solves
#: through B2 (a guidance module's T-MPC optimizer, the scenario optimizer)
#: or the single-instance solve. SH-MPC's data gate wants Gaussian
#: predictions.
SWEEP = [("no_obstacles", "configuration_no_obstacles", {}, False),
         ("no_obstacles_dynvref", "configuration_no_obstacles",
          {"contouring": {"dynamic_velocity_reference": True}}, False),
         ("basic", "configuration_basic", {}, False),
         ("lmpcc", "configuration_lmpcc", {}, False),
         ("tmpc", "configuration_tmpc", {}, True),
         ("tmpc_consistency", "configuration_tmpc_consistency_cost", {},
          True),
         ("goal_tmpc", "configuration_goal_tmpc", {}, True),
         ("safe_horizon", "configuration_safe_horizon",
          {"scenario_constraints": {"n_samples": 24},
           "probabilistic": {"enable": True}}, True),
         ("bicycle", "configuration_bicycle", {}, False)]


def b2_against_plain(dev, card, ocp, config, args, name):
    """B2 on one tick's dispatched inputs ``args`` (params (P, N, npar),
    xinit (nx,) or (P, nx), warm (P, N + 1, nz)) against its plain version: f64
    on every problem within FUSED_F64_GATE with the same success, f32 by the
    median; then the f32 kernel (median of 20) and its plain version
    (one run) timed by CUDA events.
    Returns (max|dZ| at f64, kernel ms, plain ms, f32 inputs, the f32
    solver's machinery)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused

    params, xinit, warm = args
    P = params.shape[0]
    solves = {dt: sqp_fused.make_fused_fleet_solver(ocp, config, dtype=dt,
                                                    device=dev)
              for dt in (torch.float64, torch.float32)}

    def on_card(dtype):
        return (torch.as_tensor(params, dtype=dtype, device=dev),
                torch.as_tensor(xinit, dtype=dtype, device=dev).expand(P, -1),
                torch.as_tensor(warm, dtype=dtype, device=dev))

    a64 = on_card(torch.float64)
    r_k, r_p = solves[torch.float64](*a64), solves[torch.float64].reference(
        *a64)
    sync()
    diff = (r_k.z - r_p.z).abs()
    rel = diff.amax(dim=(1, 2)) / (1.0 + r_p.z.abs().amax(dim=(1, 2)))
    err = diff.max().item()
    log(f"f64 B2 at {name} (P={P}, T={params.shape[1] + 1}): success "
        f"{r_k.success.tolist()} (plain {r_p.success.tolist()}), max|dZ| "
        f"{err:.3e}, max rel {rel.max().item():.3e}")
    check(bool((r_k.success == r_p.success).all())
          and rel.max().item() <= FUSED_F64_GATE,
          f"f64 B2 = plain at {name}: same success, per problem "
          f"max|dZ| / (1 + max|Z|) <= {FUSED_F64_GATE:g}")
    a32 = on_card(torch.float32)
    r32_k = solves[torch.float32](*a32)
    r32_p = solves[torch.float32].reference(*a32)
    sync()
    rel32 = ((r32_k.z - r32_p.z).abs().amax(dim=(1, 2))
             / (1.0 + r32_p.z.abs().amax(dim=(1, 2))))
    log(f"f32 B2 at {name}: per problem rel {rel32.tolist()}")
    check(rel32.median().item() <= 1e-4,
          f"f32 B2 = plain at {name}: median rel <= 1e-4")
    k_ms, k_all = cuda_time_ms(lambda: solves[torch.float32](*a32), reps=20)
    p_ms, _ = cuda_time_ms(lambda: solves[torch.float32].reference(*a32),
                           reps=1, warmup=0)
    log(f"[{card}] B2 at {name} (P={P}, T={params.shape[1] + 1}, f32, CUDA "
        f"events): {k_ms:.3f} ms (median of 20; {spread(k_all)}), plain "
        f"fused_fleet_reference {p_ms:.3f} ms (one run)")
    return err, k_ms, p_ms, a32, solves[torch.float32].machinery


def check_ip_count(mach, ocp, consts, name):
    """The hand count of one IP iteration at this OCP's rows and mask is
    the roofline constant the kernel entry's bound uses."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline

    ip_it = roofline.ip_iter_flops(mach.row_meta, mach.stage_mask, ocp.nx,
                                   mach.nu)
    want = getattr(roofline, f"{consts}_IP_ITER_FLOPS")
    check(ip_it == want, f"IP iteration count at {name}'s rows and mask "
          f"{ip_it} = {consts}_IP_ITER_FLOPS {want}")


def multirobot_phase(dev, card, reset_counts, counts, none):
    """(i) The fork's multi-robot coordination path on the card: three
    ``RobotAgent``s with ``systems.make_system_planner("jackalsimulator",
    "goal_tmpc")`` planners at the jackalsimulator defaults (N=30, dt 0.2, 4
    obstacles, 4 guided + 1 unguided planners, f32, the robots' 5 x 10 SQP
    under Gershgorin) on the JAX test's intersection with a crossing
    pedestrian, under one simulated clock: ``MultiRobotDriver.run`` for
    MR_CYCLES cycles, then, after an environment reset, a short
    ``run_desynchronized``; each run with the launch counts set to 0 just
    before it. Checks one B2 launch per planning tick and no other kernel,
    the fused backend, the C++ PRM and H-signature; the lockstep run also to
    no robot pair closer than 0.65 m, no contact with the pedestrian, the
    JAX test's progress and a communication rate in (0, 0.95) per robot
    (the desynchronized run's clearance is reported); prints the trigger
    reasons, the bandwidth saved, ms per robot tick and B2 ms per tick;
    holds B2 at the tick's shape against its plain version. Returns the
    kernel entry's numbers."""
    from collections import Counter

    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        prewarm_planner)
    from oscar_mpc_planner_mr_modification_tpu_torch.multirobot import (
        MessageBus, MultiRobotDriver, RobotAgent)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, _phases_of)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim import (
        Pedestrian, PedestrianSimulator)
    from oscar_mpc_planner_mr_modification_tpu_torch.systems import (
        make_system_planner)

    t_build = time.perf_counter()
    clock, bus, cfg = SimClock(), MessageBus(), SQPConfig(**MR_CFG)
    agents = []
    for i, (ns, start, goal) in enumerate(MR_ROBOTS):
        planner, model, settings = make_system_planner(
            "jackalsimulator", "goal_tmpc", dtype=torch.float32,
            sqp_config=cfg, clock=clock, device=dev)
        prewarm_planner(planner, model, settings, start_pose=start,
                        goal=goal)
        agents.append(RobotAgent(ns, i, planner, model, settings,
                                 goal=np.asarray(goal, float), bus=bus,
                                 clock=clock, start_pose=start))
    opts = [next(m for m in a.planner.modules
                 if hasattr(m, "_optimizer"))._optimizer for a in agents]
    settings = agents[0].settings
    N, P = agents[0].planner.solver.N, opts[0].n_planners
    ocp = agents[0].planner.solver.ocp
    log(f"multi-robot: {len(agents)} goal_tmpc robots built and prewarmed in "
        f"{time.perf_counter() - t_build:.2f} s (N={N}, P={P}, max_obstacles "
        f"{settings['max_obstacles']}, npar {ocp.npar})")
    check((N, P, settings["max_obstacles"], ocp.npar) == (30, 5, 4, 50),
          "jackalsimulator goal_tmpc: N=30, 4 guided + 1 unguided planners, "
          "4 obstacles, npar 50")
    for a, opt in zip(agents, opts):
        check(opt.fleet_backend == "fused"
              and opt.global_guidance.signature_backend == "cpp",
              f"{a.ns}: fleet backend {opt.fleet_backend!r} == 'fused', "
              f"H-signature {opt.global_guidance.signature_backend!r} == "
              f"'cpp'")
    driver = MultiRobotDriver(agents, clock=clock)
    r_robot = float(settings["robot_radius"])
    psim = PedestrianSimulator([Pedestrian(np.array(MR_PEDESTRIAN[0]),
                                           np.array(MR_PEDESTRIAN[1]))],
                               dt=float(settings["integrator_step"]))
    ped_clear = [np.inf]

    def clearance():
        ped = psim.pedestrians[0]
        return min(np.linalg.norm(a.state.get_position() - ped.position)
                   - ped.radius - r_robot for a in agents)

    def provider(cycle, every=1):
        # the pedestrian steps once per planning period: every cycle of
        # the lockstep run, every ``every`` simulation substeps of the
        # desynchronized one
        ped_clear[0] = min(ped_clear[0], clearance())
        if cycle % every == 0:
            psim.step([a.state.get_position() for a in agents])
        return psim.get_obstacles(N)

    rec = {"tick_ms": [], "solves": 0, "captured": None}
    for a in agents:
        tick, solve = a.tick, a.planner.solve_mpc

        def timed(external_obstacles=None, _tick=tick):
            n0 = rec["solves"]
            t0 = time.perf_counter()
            m = _tick(external_obstacles=external_obstacles)
            if rec["solves"] > n0:
                rec["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            return m

        def counted(*args, _solve=solve, **kw):
            rec["solves"] += 1
            return _solve(*args, **kw)

        a.tick, a.planner.solve_mpc = timed, counted
    dispatch = opts[0]._dispatch_batch

    def spy(params, xinit, warm):
        if rec["captured"] is None and rec["solves"] >= 20:
            rec["captured"] = (params.copy(), np.array(xinit), warm.copy())
        return dispatch(params, xinit, warm)

    opts[0]._dispatch_batch = spy
    for opt in opts:
        opt.global_guidance.ran_backend = None
    reset_counts()
    t0 = time.perf_counter()
    mlog = driver.run(MR_CYCLES, obstacle_provider=provider)
    sync()
    wall = time.perf_counter() - t0
    got = counts()
    ped_clear[0] = min(ped_clear[0], clearance())
    opts[0].__dict__.pop("_dispatch_batch", None)
    check(got == {**none, "sqp_fused": rec["solves"]} and rec["solves"] > 0,
          f"multi-robot run: launches {got} (want one B2 launch per planning "
          f"tick, {rec['solves']}, and no other kernel)")
    for a, opt in zip(agents, opts):
        check(opt.global_guidance.ran_backend == "cpp",
              f"{a.ns}: guidance PRM backend "
              f"{opt.global_guidance.ran_backend!r} == 'cpp'")
    tracks = {a.ns: np.array([[m.position_x, m.position_y]
                              for m in mlog.records[a.ns]]) for a in agents}
    names = list(tracks)
    d_min = min(np.linalg.norm(tracks[p][:n] - tracks[q][:n], axis=1).min()
                for i, p in enumerate(names) for q in names[i + 1:]
                for n in [min(len(tracks[p]), len(tracks[q]))])
    check(d_min > 0.65, f"multi-robot run: smallest distance between two "
          f"robots {d_min:.4f} m > 0.65 m")
    check(ped_clear[0] > 0.0, f"multi-robot run: smallest clearance to the "
          f"pedestrian {ped_clear[0]:.4f} m > 0 (centre distance minus both "
          f"radii)")
    pos = [a.state.get_position() for a in agents]
    check(pos[0][0] > 6.5 and pos[1][0] < 5.5 and pos[2][1] > 0.0,
          f"multi-robot run: progress r1 x {pos[0][0]:.3f} > 6.5, r2 x "
          f"{pos[1][0]:.3f} < 5.5, r3 y {pos[2][1]:.3f} > 0")
    saved = {}
    for a in agents:
        rate = mlog.communication_rate(a.ns)
        saved[a.ns] = 1.0 - rate
        reasons = Counter(m.communication_trigger for m in mlog.records[a.ns]
                          if m.communicated)
        log(f"[{card}] multi-robot {a.ns}: {a.comm.n_sent} trajectories sent "
            f"over {a.comm.n_cycles} planning cycles, communication rate "
            f"{rate:.4f} (bandwidth saved {1.0 - rate:.4f}), triggers "
            f"{dict(reasons)}, final FSM {a.fsm.name}, success "
            f"{mlog.success_rate(a.ns):.4f}")
        check(0.0 < rate < 0.95, f"{a.ns}: communication rate {rate:.4f} in "
              f"(0, 0.95)")
    t_ms = np.asarray(rec["tick_ms"])
    launches = got["sqp_fused"]
    err, k_ms, p_ms, a32, mach = b2_against_plain(
        dev, card, ocp, cfg, rec["captured"], "the multi-robot tick's shape")
    check_ip_count(mach, ocp, "MRTICK", "the multi-robot tick")
    log(f"[{card}] multi-robot run ({MR_CYCLES} cycles, {rec['solves']} "
        f"planning ticks, {wall:.2f} s): ms per robot tick median "
        f"{np.median(t_ms):.3f}, p99 {np.percentile(t_ms, 99):.3f}; B2 per "
        f"tick {k_ms:.3f} ms (CUDA events), host share of the median tick "
        f"{1.0 - k_ms / np.median(t_ms):.4f}")

    # a short desynchronized run after an environment reset
    driver.reset_environment()
    psim = PedestrianSimulator([Pedestrian(np.array(MR_PEDESTRIAN[0]),
                                           np.array(MR_PEDESTRIAN[1]))],
                               dt=float(settings["integrator_step"]))
    ped_clear[0] = np.inf
    rec["solves"], rec["tick_ms"] = 0, []
    reset_counts()
    substeps = 4
    dlog = driver.run_desynchronized(
        MR_DESYNC_CYCLES, sim_substeps=substeps, seed=0,
        obstacle_provider=lambda c: provider(c, every=substeps))
    sync()
    got = counts()
    check(got == {**none, "sqp_fused": rec["solves"]} and rec["solves"] > 0,
          f"desynchronized run: launches {got} (want one B2 launch per "
          f"planning tick, {rec['solves']}, and no other kernel)")
    check(all(np.isfinite(a.state.as_array()).all() for a in agents),
          "desynchronized run: finite states")
    log(f"[{card}] desynchronized run ({MR_DESYNC_CYCLES} periods, not "
        f"gated): smallest clearance to the pedestrian {ped_clear[0]:.4f} m")
    log(f"[{card}] desynchronized run ({MR_DESYNC_CYCLES} periods): "
        f"{rec['solves']} planning ticks, ms per robot tick median "
        f"{np.median(rec['tick_ms']):.3f}; states "
        f"{[a.fsm.name for a in agents]}; communication rates "
        f"{[round(dlog.communication_rate(a.ns), 4) for a in agents]}")
    return dict(metrics_log=mlog, launches=launches, err=err, ms=k_ms,
                plain_ms=p_ms,
                flops=roofline.sqp_flops(
                    P, _phases_of(cfg), lin=roofline.MRTICK_LIN_FLOPS,
                    merit=roofline.MRTICK_MERIT_FLOPS,
                    ip_iter=roofline.MRTICK_IP_ITER_FLOPS),
                n_bytes=roofline.tensor_bytes(*a32, a32[2]) + 8 * P)


def dynvref_phase(dev, card, reset_counts, counts, none):
    """(j) The dynamic velocity reference through B2: the in-kernel
    linearization of the dyn-vref T-MPC OCP against torch.func at f64 (64
    problems; lin_against_torch_func), the dyn-vref fleet
    (tools/bench_matrix.py::build_dynvref, 512 problems) through B2 against
    its plain version, and DYNVREF_TICKS serial planner ticks of
    configuration_tmpc_consistency_cost with the flag on, on a path whose
    velocities fall from 2.0 to 0.5 m/s, with the launch counts set to 0
    before them: one B2 launch per tick, every tick solved, and |v -
    v_ref(s)| smaller over the last 20 ticks than over the first 20.
    Returns the fleet's kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        build_planner, configuration_tmpc_consistency_cost, prewarm_planner)
    from oscar_mpc_planner_mr_modification_tpu_torch.multirobot.driver import (  # noqa: E501
        integrate_on_host)
    from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E501
        define_robot_area, ensure_obstacle_size)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim.roadmap import (
        straight_path)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)
    from oscar_mpc_planner_mr_modification_tpu_torch.types import RealTimeData
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    # the in-kernel linearization at f64
    ocp, P, x0, z0 = bench_matrix.build_dynvref(N_MAIN, 8)
    z0 = z0 + 0.05 * np.random.default_rng(0).normal(size=z0.shape)
    lin_against_torch_func(dev, ocp, np.concatenate([P, P[:, -1:]], axis=1),
                           x0, z0, "dyn-vref")

    ocp512, *arrays512 = bench_matrix.build_dynvref(N_MAIN, 64)
    entry = fleet_flavour_phase(dev, card, reset_counts, counts, none,
                                "dyn-vref T-MPC", ocp512, arrays512, "VREF",
                                b1=False)["b2"]

    # the planner on a path whose reference velocity falls
    settings = default_settings(
        N=N_MAIN, max_obstacles=3,
        contouring={"dynamic_velocity_reference": True})
    model, modules = configuration_tmpc_consistency_cost(settings)
    clock = SimClock()
    planner = build_planner(model, modules, settings, dtype=torch.float32,
                            sqp_config=bench_config(), clock=clock,
                            device=dev)
    prewarm_planner(planner, model, settings)
    path = straight_path(length=40.0)
    path.v = list(np.linspace(2.0, 0.5, len(path.x)))
    state = State(model)
    state.set("v", 1.0)
    dt = float(settings["integrator_step"])

    def data_now():
        d = RealTimeData()
        d.robot_area = define_robot_area(0.65, 0.65, 1)
        d.reference_path = path
        d.dynamic_obstacles = ensure_obstacle_size(
            [], state, settings["max_obstacles"], N_MAIN, dt)
        return d

    planner.on_data_received(data_now(), "reference_path")
    errs, ok, iv = [], 0, model.state_index("v")
    reset_counts()
    for _ in range(DYNVREF_TICKS):
        out = planner.solve_mpc(state, data_now())
        ok += bool(out.success)
        a = planner.get_solution(0, "a") if out.success else -3.0
        w = planner.get_solution(0, "w") if out.success else 0.0
        x = integrate_on_host(model, state.as_array(), [a, w], dt)
        x[iv] = max(x[iv], 0.0)
        state.set_array(x)
        clock.t += dt
        v_ref = np.interp(state.get("x"), path.s, path.v)
        errs.append(abs(state.get("v") - v_ref))
    sync()
    got = counts()
    check(got == {**none, "sqp_fused": DYNVREF_TICKS},
          f"dyn-vref ticks: launches {got} (want one B2 launch per tick, "
          f"{DYNVREF_TICKS}, and no other kernel)")
    first, last = float(np.mean(errs[:20])), float(np.mean(errs[-20:]))
    log(f"[{card}] dyn-vref ticks: {ok}/{DYNVREF_TICKS} solved, x "
        f"{state.get('x'):.3f} m, v {state.get('v'):.3f} m/s; mean |v - "
        f"v_ref(s)| first 20 ticks {first:.4f}, last 20 {last:.4f}")
    check(ok == DYNVREF_TICKS, f"dyn-vref ticks: every tick solved ({ok})")
    check(last < first, f"dyn-vref ticks: mean |v - v_ref(s)| over the last "
          f"20 ticks {last:.4f} < over the first 20 {first:.4f}")
    return entry


def sweep_phase(dev, card, reset_counts, counts, none):
    """(k) The nine configurations of the JAX package's configuration sweep,
    each as a ``build_planner(..., device=dev)``
    planner for SWEEP_TICKS ticks at N=8 (f64, 6 x 10 under Gershgorin) on
    its benign scene, with the launch counts set to 0 before each: the
    T-MPC and SH-MPC ones one B2 launch per tick, the others (no guidance or
    scenario module) the single-instance solve, one S1 launch per tick; at
    least 2 of 3 ticks solved and x >
    0.1. Then the LMPCC fleet (tools/bench_matrix.py::build_lmpcc, 512
    problems) through B2 against its plain version, and one
    ``LocalPlannerInterface.compute_velocity_commands`` cycle (basic, N=8)
    on the card (one S1 launch). Returns the LMPCC fleet's kernel entry
    numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch import factory
    from oscar_mpc_planner_mr_modification_tpu_torch.multirobot.driver import (  # noqa: E501
        integrate_on_host)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig
    from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E501
        define_robot_area, ensure_obstacle_size)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim import (
        Pedestrian, PedestrianSimulator)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim.roadmap import (
        straight_path)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
    from oscar_mpc_planner_mr_modification_tpu_torch.systems import (
        LocalPlannerInterface)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)
    from oscar_mpc_planner_mr_modification_tpu_torch.types import RealTimeData
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    cfg = SQPConfig(n_sqp=6, n_qp_iter=10, mu_min=1e-9,
                    regularization="gershgorin")
    N = SWEEP_N
    for name, conf, overrides, b2 in SWEEP:
        settings = default_settings(N=N, max_obstacles=2, **overrides)
        model, modules = getattr(factory, conf)(settings)
        planner = factory.build_planner(model, modules, settings,
                                        dtype=torch.float64, sqp_config=cfg,
                                        device=dev)
        state = State(model)
        state.set("v", 0.6)
        psim = PedestrianSimulator([Pedestrian(np.array([6.0, 2.0]),
                                               np.array([6.0, -2.0]))],
                                   dt=0.2)
        prob = bool(settings["probabilistic"]["enable"])
        n_ok = 0
        reset_counts()
        t0 = time.perf_counter()
        for tick in range(SWEEP_TICKS):
            data = RealTimeData()
            data.robot_area = define_robot_area(0.65, 0.65, 1)
            data.reference_path = straight_path(length=20.0)
            data.goal = np.array([6.0, 0.0])
            data.goal_received = True
            data.dynamic_obstacles = ensure_obstacle_size(
                psim.get_obstacles(N, probabilistic=prob), state,
                settings["max_obstacles"], N, 0.2, probabilistic=prob)
            if tick == 0:
                for what in ("reference_path", "goal", "dynamic obstacles"):
                    planner.on_data_received(data, what)
            out = planner.solve_mpc(state, data)
            check(bool(np.isfinite(
                planner.solver.get_output_trajectory()).all()),
                f"sweep {name}: finite output trajectory")
            if out.success:
                n_ok += 1
                x = integrate_on_host(
                    model, state.as_array(),
                    [planner.get_solution(0, "a"),
                     planner.get_solution(0, "w")] + [0.0] * (model.nu - 2),
                    0.2)
                x[model.state_index("v")] = max(x[model.state_index("v")],
                                                0.0)
                state.set_array(x)
            psim.step([state.get_position()])
        sync()
        got = counts()
        path = "B2" if b2 else "S1 (the single-instance solve)"
        want = {**none, ("sqp_fused" if b2 else "sqp_single"): SWEEP_TICKS}
        log(f"[{card}] sweep {name}: {n_ok}/{SWEEP_TICKS} ticks solved "
            f"through {path} in {time.perf_counter() - t0:.2f} s, x "
            f"{state.get('x'):.3f}, launches {got}")
        check(got == want, f"sweep {name}: launches {got} == {want} ({path})")
        check(n_ok >= 2 and state.get("x") > 0.1, f"sweep {name}: {n_ok} of "
              f"{SWEEP_TICKS} ticks solved (>= 2), x {state.get('x'):.3f} > "
              f"0.1")

    ocp, *arrays = bench_matrix.build_lmpcc(N_MAIN, MATRIX_B,
                                            np.random.default_rng(0))
    entry = fleet_flavour_phase(dev, card, reset_counts, counts, none,
                                "LMPCC", ocp, arrays, "LMPCC",
                                b1=False)["b2"]

    lp = LocalPlannerInterface(configuration="basic", N=SWEEP_N,
                               max_obstacles=2, device=dev)
    lp.set_plan(np.stack([np.linspace(0, 15, 20), np.zeros(20)], axis=1))
    reset_counts()
    t0 = time.perf_counter()
    v, w, ok = lp.compute_velocity_commands((0.0, 0.2, 0.0), 0.5)
    sync()
    got = counts()
    log(f"[{card}] LocalPlannerInterface (basic, N={SWEEP_N}): v {v:.4f}, "
        f"w {w:.4f}, success {ok} in {time.perf_counter() - t0:.2f} s")
    check(ok and v > 0.3 and abs(w) < 1.0
          and got == {**none, "sqp_single": 1} and not lp.is_goal_reached(),
          f"LocalPlannerInterface cycle on the card: success, v > 0.3, |w| < "
          f"1, one S1 launch (the single-instance solve) and no other "
          f"kernel, goal not reached ({got})")
    return entry

#: The item-4d fleets: 512 problems each, f32, tools/bench_matrix.py's
#: operating point; the bicycles at default_settings() (N=30).
BICYCLE_N, CA_N, DECOMP_N = 30, 20, 20
CORRIDOR_N, CORRIDOR_TICKS = 12, 3
#: JAX's corridor test's SQP (tests/test_scenario.py): 8 x 12.
CORRIDOR_CFG = dict(n_sqp=8, n_qp_iter=12)
BICYCLE_GOLDEN_CFG = dict(n_sqp=15, n_qp_iter=15)


def bicycle_phase(dev, card, reset_counts, counts, none):
    """(l) The bicycles: configuration_bicycle and its curvature-aware
    variant at default_settings() (N=30, nx=6, nu=3, 4 ellipsoids, m=22) as
    512-problem fleets through B2 (one launch) and through B1 at (6, 3)
    (``"pallas"``, one launch per SQP iteration), each held against its
    plain version (fleet_flavour_phase); their launch plans at T=31, nz=9;
    then the bicycle_contouring golden through make_sqp_solver at f64 on
    the card (one S1 launch; atol 1e-6, cost rtol 1e-8, as
    tests/test_golden.py holds JAX), with ms per solve. Returns the kernel
    entries by name."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_bicycle)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, make_fleet_sqp_solver, make_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    out = {}
    rng = np.random.default_rng(10)
    for ca, name, prefix in ((False, "bicycle", "BICYCLE"),
                             (True, "CA bicycle", "BICYCLE_CA")):
        ocp, *arrays = bench_matrix.build_bicycle(BICYCLE_N, MATRIX_B, rng,
                                                  curvature_aware=ca)
        check((ocp.N, ocp.nx, ocp.nu, ocp.npar, len(ocp.ineq_row_spec()))
              == (30, 6, 3, 84, 22), f"{name} OCP sizes (N, nx, nu, npar, m)")
        log_plans(dev, ocp, make_fleet_sqp_solver(
            ocp, bench_config(), dtype=torch.float32, device="cpu",
            backend="fused").tables)
        out[name] = fleet_flavour_phase(dev, card, reset_counts, counts, none,
                                        name, ocp, arrays, prefix)

    gold = np.load(os.path.join(ROOT, "tests", "golden",
                                "bicycle_contouring.npz"))
    settings = default_settings(N=15, max_obstacles=2)
    ocp = build_ocp(*configuration_bicycle(settings), settings)
    solve = make_sqp_solver(ocp, SQPConfig(**BICYCLE_GOLDEN_CFG),
                            dtype=torch.float64, device=dev)
    args = (gold["P"], gold["x0"], gold["z_init"])
    reset_counts()
    sync()
    t0 = time.perf_counter()
    res = solve(*args)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    zerr = float(np.abs(res.z.cpu().numpy() - gold["Z"]).max())
    cost = float(res.cost)
    log(f"[{card}] bicycle_contouring golden (N=15, 15 x 15, f64, "
        f"make_sqp_solver on {res.z.device}): max|Z - Z_gold| {zerr:.3e}, "
        f"cost {cost:.12f} vs {float(gold['cost']):.12f}, {ms:.1f} ms per "
        f"solve (S1), launches {got}")
    check(got == {**none, "sqp_single": 1} and res.z.device.type == "cuda",
          f"bicycle golden on the card: one S1 launch and no other kernel "
          f"({got})")
    check(bool(res.success) and zerr <= 1e-6
          and abs(cost - float(gold["cost"])) <= 1e-8 * abs(
              float(gold["cost"])),
          "bicycle golden: success, Z within atol 1e-6, cost within rtol "
          "1e-8")
    return out


def lin_against_torch_func(dev, ocp, P, x0, Z, name):
    """B2's linearize entry against build_qp / merit_of (torch.func) at
    f64 on every field (rtol LIN_F64_RTOL, atol LIN_F64_ATOL), every field
    finite. Returns the largest difference."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        QPData, make_fleet_sqp_solver)

    fs = make_fleet_sqp_solver(ocp, bench_config(), dtype=torch.float64,
                               device=dev, backend="fused")
    args = tuple(torch.as_tensor(a, dtype=torch.float64, device=dev)
                 for a in (P, x0, Z))
    got = sqp_fused.linearize(fs.tables, *args)
    want = sqp_fused.linearize_reference(fs.machinery, fs.tables, *args)
    sync()
    worst, err, finite = [], 0.0, True
    for field, a, b in zip(QPData._fields + ("merit", "cost", "eq_res"),
                           tuple(got[0]) + tuple(got[1:]),
                           tuple(want[0]) + tuple(want[1:])):
        finite = finite and bool(torch.isfinite(a).all())
        err = max(err, (a - b).abs().max().item())
        if not torch.allclose(a, b, rtol=LIN_F64_RTOL, atol=LIN_F64_ATOL):
            worst.append(field)
    log(f"f64 {name} linearize ({P.shape[0]} problems): max|d| {err:.3e} "
        f"over every field, finite {finite}")
    check(finite and not worst, f"f64 in-kernel linearization of the {name} "
          f"OCP = build_qp on every field within rtol {LIN_F64_RTOL:g}, atol "
          f"{LIN_F64_ATOL:g}, no NaN (failed: {worst})")
    return err


def ca_phase(dev, card, reset_counts, counts, none):
    """(m) The curvature-aware unicycle (tools/bench_matrix.py::
    build_ca_unicycle: MPCBase, the CA contouring cost, 3 ellipsoids,
    N=20): B2's in-kernel linearization, its progress update and CA cost
    included, against torch.func at f64 on 64 problems on curved paths and
    on the same paths made exactly straight (no NaN; the CA bicycle's too),
    then its 512-problem fleet through B2 against the plain version.
    Returns the fleet's kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    rng = np.random.default_rng(11)
    for name, (ocp, P, x0, z0) in (
            ("CA unicycle", bench_matrix.build_ca_unicycle(CA_N, 64, rng)),
            ("CA bicycle", bench_matrix.build_bicycle(BICYCLE_N, 64, rng,
                                                      True))):
        P = np.concatenate([P, P[:, -1:]], axis=1).astype(np.float64)
        Z = z0 + 0.05 * np.random.default_rng(0).normal(size=z0.shape)
        straight = P.copy()
        for i in range(5):
            for c in "abcd":
                straight[..., ocp.registry.index(f"spline_y{i}_{c}")] = 0.0
        for path, Pp in (("curved", P), ("straight", straight)):
            lin_against_torch_func(dev, ocp, Pp, x0, Z, f"{name}, {path} path")
    ocp, *arrays = bench_matrix.build_ca_unicycle(CA_N, MATRIX_B, rng)
    return fleet_flavour_phase(dev, card, reset_counts, counts, none,
                               "CA-MPC", ocp, arrays, "CA", b1=False)["b2"]


def decomp_phase(dev, card, reset_counts, counts, none):
    """(n) Decomp and road width: the decomposition's backend is the C++
    library; the decomp fleet (tools/bench_matrix.py::build_decomp:
    configuration_no_obstacles plus 12 decomp rows, npar 90, m=26, N=20, 512
    corridors) through B2 against its plain version; CORRIDOR_TICKS ticks of
    JAX's corridor scene (tests/test_scenario.py: walls at y = +-1 over 8
    m, N=12, 8 x 12 SQP, f64) through ``LocalPlannerInterface.set_costmap``
    / ``compute_velocity_commands`` on the card (the single-instance solve,
    host-bound, B-5: timed, not gated), each solved with its plan inside
    |y| < 1.0 and the last plan past x = 1.5 m (JAX's assertions); then the
    road-width bicycle fleet (configuration_bicycle plus
    ContouringConstraintModule, N=30, 512 problems) through B2 against its
    plain version. Returns the two fleets' kernel entry numbers."""
    from oscar_mpc_planner_mr_modification_tpu_torch import factory
    from oscar_mpc_planner_mr_modification_tpu_torch.modules import (
        DecompConstraintModule)
    from oscar_mpc_planner_mr_modification_tpu_torch.multirobot.driver import (  # noqa: E501
        integrate_on_host)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.decomp import (
        EllipsoidDecomp2D)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig
    from oscar_mpc_planner_mr_modification_tpu_torch.systems import (
        LocalPlannerInterface)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    backend = EllipsoidDecomp2D().backend
    log(f"decomp backend: {backend}")
    check(backend == "cpp", f"the decomposition runs the C++ library "
          f"(backend {backend!r})")
    rng = np.random.default_rng(12)
    ocp, *arrays = bench_matrix.build_decomp(DECOMP_N, MATRIX_B, rng)
    check((ocp.npar, ocp.nh, len(ocp.ineq_row_spec())) == (90, 12, 26),
          "decomp OCP sizes (npar, rows, m)")
    out = {"decomp": fleet_flavour_phase(dev, card, reset_counts, counts,
                                         none, "decomp", ocp, arrays,
                                         "DECOMP", b1=False)["b2"]}

    def with_decomp(settings):
        model, modules = factory.configuration_no_obstacles(settings)
        modules.add_module(DecompConstraintModule(settings))
        return model, modules

    lp = LocalPlannerInterface(configuration=with_decomp, N=CORRIDOR_N,
                               max_obstacles=2, device=dev,
                               sqp_config=SQPConfig(**CORRIDOR_CFG))
    dmod = next(m for m in lp.planner.modules
                if isinstance(m, DecompConstraintModule))
    check(dmod.decomp.backend == "cpp", "the planner's decomp module runs "
          "the C++ library")
    lp.set_plan(np.stack([np.linspace(0, 15, 16), np.zeros(16)], axis=1))
    lp.set_costmap(bench_matrix.corridor_points(1.0, length=8.0,
                                                spacing=0.25))
    ix, iy = lp.model.var_index("x"), lp.model.var_index("y")
    pose, v, times, inside = np.zeros(3), 1.0, [], True
    reset_counts()
    for _ in range(CORRIDOR_TICKS):
        t0 = time.perf_counter()
        v_cmd, w_cmd, ok = lp.compute_velocity_commands(tuple(pose), v)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        check(ok, "corridor tick solved")
        traj = lp.planner.solver.get_output_trajectory()
        inside = inside and bool(np.all(np.abs(traj[:, iy]) < 1.0))
        check(bool((dmod._b[0, 1:] < 999.0).any()),
              "the decomposition produced halfspaces")
        x = integrate_on_host(lp.model, lp.state.as_array(),
                              [lp.planner.get_solution(0, "a"), w_cmd], 0.2)
        pose = x[[lp.model.state_index(n) for n in ("x", "y", "psi")]]
        v = float(x[lp.model.state_index("v")])
    got = counts()
    log(f"[{card}] corridor ticks through LocalPlannerInterface (N="
        f"{CORRIDOR_N}, f64, the single-instance solve on S1): ms per tick "
        f"{[round(t, 1) for t in times]}, last plan x {traj[-1, ix]:.3f} m, "
        f"max |y| {np.abs(traj[:, iy]).max():.4f}, launches {got}")
    check(got == {**none, "sqp_single": CORRIDOR_TICKS}, f"corridor ticks: "
          f"one S1 launch per tick and no other kernel ({got})")
    check(inside and traj[-1, ix] > 1.5, "corridor ticks: every plan inside "
          "|y| < 1.0, the last past x = 1.5 m")

    ocp, *arrays = bench_matrix.build_bicycle(BICYCLE_N, MATRIX_B, rng,
                                              road_width=True)
    out["road"] = fleet_flavour_phase(dev, card, reset_counts, counts, none,
                                      "road-width bicycle", ocp, arrays,
                                      "ROAD", b1=False)["b2"]
    return out


# ---------------------------------------------------------------------------
# (o) The sharded fleet step (parallel/mesh.py) and the host layers
# ---------------------------------------------------------------------------
#: The mesh step's tolerance against the unsharded fused step: the same B2
#: arithmetic per problem, so equal up to 1e-6 relative (printed: bitwise).
MESH_RTOL = 1e-6
MESH_TIMEOUT_S = 300.0


def same_winners(got, ref, name):
    """Index equal everywhere, cost and z within MESH_RTOL relative; prints
    whether the two are bitwise equal. ``got`` is (best_z, best_cost,
    best_index, any_ok) as numpy, ``ref`` a TMPCStepResult."""
    z, cost, index, ok = got
    rz, rcost = ref.best_z.cpu().numpy(), ref.best_cost.cpu().numpy()
    rindex, rok = ref.best_index.cpu().numpy(), ref.any_success.cpu().numpy()
    fin = np.isfinite(rcost)
    dcost = np.abs(cost[fin] - rcost[fin]) / np.abs(rcost[fin])
    dz = (np.abs(z - rz).reshape(len(z), -1).max(axis=1)
          / (1.0 + np.abs(rz).reshape(len(z), -1).max(axis=1)))
    bitwise = (np.array_equal(z, rz) and np.array_equal(cost, rcost)
               and np.array_equal(index, rindex))
    log(f"{name} against the unsharded fused step: index equal on "
        f"{np.mean(index == rindex):.6f} of plans, max rel cost "
        f"{dcost.max(initial=0.0):.3e}, max per-plan rel z "
        f"{dz.max(initial=0.0):.3e}; bitwise equal: {bitwise}")
    check(np.array_equal(index, rindex) and np.array_equal(ok, rok)
          and np.array_equal(np.isfinite(cost), fin)
          and dcost.max(initial=0.0) <= MESH_RTOL
          and dz.max(initial=0.0) <= MESH_RTOL,
          f"{name}: the unsharded fused step's winners (index, any_ok; cost "
          f"and z within {MESH_RTOL:g} relative)")
    return bitwise


def mesh_phase(dev, card, reset_counts, counts, none):
    """(o) The sharded fleet step of ``parallel/mesh.py`` on the card, each
    run with the launch counts set to 0 just before it. (o1) A 1x1 grid on
    an NCCL group of one rank at the bench fleet (B=512, P=9, N=20, f32,
    BENCH_SCHEDULE): "auto" resolves to "fused", the champions stay on the
    card, one B2 launch per step and no other kernel, the unsharded fused
    step's winners; the two steps timed by CUDA events (median of 20, in
    turns), B2 alone, the step through B2's plain twin, and at f64 (B=64)
    kernel against plain. (o2) A 2x2 grid of four spawned processes on
    this card in a gloo group (host staging), the fleet padded to P=10 with
    a disabled planner: one B2 launch of 256 x 5 = 1280 problems per rank,
    the unsharded step's winners, gathered elements against the champion
    payload, per-rank ms (not gated: four processes share the card). (o3)
    ``dryrun_multichip(4)``. The children only load the libraries this
    process built (``qp_cuda.require_built``). Returns the kernel entry's
    numbers."""
    import tempfile

    import torch.distributed as dist

    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        build_tmpc_fleet, tmpc_bench_ocp)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline, sqp_fused)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import mesh
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        make_batched_tmpc_step, to_torch_fleet)

    t_phase = time.perf_counter()
    cfg = bench_config()
    ocp, settings = tmpc_bench_ocp(N=N_MAIN, n_paths=N_PATHS)
    arrays = build_tmpc_fleet(ocp, settings, B_MAIN, seed=0)
    args = to_torch_fleet(*arrays, device=dev, dtype=torch.float32)
    P = N_PATHS + 1
    payload = (N_MAIN + 1) * ocp.nvar + 2
    ref_step = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32,
                                      device=dev, backend="fused")
    ref = ref_step(*args)
    sync()

    # ---- (o1) 1x1 on NCCL ------------------------------------------------
    with tempfile.TemporaryDirectory() as work:
        dist.init_process_group("nccl", init_method=f"file://{work}/store",
                                rank=0, world_size=1)
        try:
            grid = mesh.make_mesh(1, 1)
            step = mesh.make_sharded_tmpc_step(ocp, cfg, grid,
                                               dtype=torch.float32, device=dev)
            check(step.backend == "fused" and step.staging == "device",
                  f"(o1) 1x1 NCCL mesh step: backend {step.backend!r} == "
                  f"'fused' (from 'auto'), staging {step.staging!r} == "
                  f"'device'")
            reset_counts()
            out = step(*args)
            sync()
            got = counts()
            check(got == {**none, "sqp_fused": 1},
                  f"(o1) mesh step launches {got} (want one B2 launch, no "
                  f"other kernel)")
            launches = got["sqp_fused"]
            bitwise = same_winners(tuple(x.cpu().numpy() for x in out), ref,
                                   "(o1) mesh step")
            check(step.gathered_elements == B_MAIN * payload,
                  f"(o1) gathered {step.gathered_elements} elements = B x "
                  f"((N+1) nvar + 2) = {B_MAIN * payload}")
            times = {"mesh": [], "unsharded": []}
            for name in ("mesh", "unsharded", "unsharded", "mesh"):
                fn = step if name == "mesh" else ref_step
                times[name] += cuda_time_ms(lambda: fn(*args), reps=10)[1]
            mesh_ms = float(np.median(times["mesh"]))
            ref_ms = float(np.median(times["unsharded"]))
            flat = flat_fleet(args)
            f_ms, f_all = cuda_time_ms(lambda: step.fleet_solve(*flat),
                                       reps=20)
            log(f"[{card}] (o1) 1x1 mesh step ({B_MAIN} x {P}, N={N_MAIN}, "
                f"f32, CUDA events, median of 20 in turns): {mesh_ms:.3f} ms "
                f"against the unsharded fused step {ref_ms:.3f} ms: the mesh "
                f"layer costs {mesh_ms - ref_ms:.3f} ms; B2 alone {f_ms:.3f} "
                f"ms (median of 20; {spread(f_all)}); bitwise {bitwise}")
            with plain_fused_solver(step.fleet_solve):
                reset_counts()
                out_p = step(*args)
                sync()
                check(counts() == none, "(o1) plain mesh step launched no "
                      "kernel")
                plain_ms, _ = cuda_time_ms(lambda: step(*args), reps=1,
                                           warmup=0)
            agree = (out[3] == out_p[3]).float().mean().item()
            log(f"[{card}] (o1) mesh step through B2's plain twin: "
                f"{plain_ms:.3f} ms (one run), any_ok agreement "
                f"{agree:.6f}")
            check(agree >= 0.99, "(o1) f32 mesh step any_ok agrees with its "
                  "plain step on >= 99% of plans")

            ocp64, args64 = bench_fleet(64, torch.float64, dev)
            step64 = mesh.make_sharded_tmpc_step(ocp64, cfg, grid,
                                                 dtype=torch.float64,
                                                 device=dev)
            out_k = step64(*args64)
            with plain_fused_solver(step64.fleet_solve):
                out_p = step64(*args64)
            sync()
            dz = (out_k[0] - out_p[0]).abs()
            rel = (dz.amax(dim=(1, 2))
                   / (1.0 + out_p[0].abs().amax(dim=(1, 2))))
            err = dz.max().item()
            log(f"(o1) f64 mesh step at B=64 ({64 * P} problems), kernel "
                f"against plain: same index {bool(torch.equal(out_k[2], out_p[2]))}, "
                f"max|dz| {err:.3e}, max per-plan rel {rel.max().item():.3e}")
            check(torch.equal(out_k[2], out_p[2])
                  and torch.equal(out_k[3], out_p[3])
                  and rel.max().item() <= FUSED_F64_GATE,
                  f"(o1) f64 mesh step = its plain step: same winners and "
                  f"any_ok, per plan max|dz| / (1 + max|z|) <= "
                  f"{FUSED_F64_GATE:g}")
        finally:
            dist.destroy_process_group()

    # ---- (o2) 2x2 on one card: four processes, gloo, host staging -------
    params, xinit, z_init, disabled = arrays
    pad = lambda x: np.concatenate([x, x[:, -1:]], axis=1)  # noqa: E731
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "fleet.npz")
        np.savez(path, params=pad(params), xinit=xinit, z_init=pad(z_init),
                 disabled=np.concatenate(
                     [disabled, np.ones((B_MAIN, 1), bool)], axis=1))
        case = mesh.FleetCase("o2", (2, 2), dict(N=N_MAIN, n_paths=N_PATHS),
                              cfg, path, dtype=torch.float32, repeat=20)
        qp_cuda.require_built(("sqp_fused",))
        t = time.perf_counter()
        ranks = mesh.run_ranks(4, [case], work, devices=[str(dev)] * 4,
                               dist_backend="gloo",
                               timeout_s=MESH_TIMEOUT_S)["o2"]
        spawn_s = time.perf_counter() - t
    b_loc, p_loc = B_MAIN // 2, (P + 1) // 2
    for r in ranks:
        check(str(r["backend"]) == "fused" and str(r["staging"]) == "host"
              and int(r["b2_launches"]) == 1 and int(r["b1_launches"]) == 0,
              f"(o2) rank {tuple(int(c) for c in r['coords'])}: backend {r['backend']}, "
              f"staging {r['staging']}, {int(r['b2_launches'])} B2 launch of "
              f"{b_loc} x {p_loc} = {b_loc * p_loc} problems, "
              f"{int(r['b1_launches'])} QP-kernel launches")
        check(int(r["gathered_elements"]) == b_loc * 2 * payload,
              f"(o2) rank {tuple(int(c) for c in r['coords'])} gathered "
              f"{int(r['gathered_elements'])} elements = b_loc x S x "
              f"((N+1) nvar + 2) = {b_loc * 2 * payload} (the fleet's params "
              f"hold {params.size})")
    got = tuple(mesh.gather_rows(ranks, k)
                for k in ("best_z", "best_cost", "best_index", "any_ok"))
    bitwise2 = same_winners(got, ref, "(o2) 2x2 mesh step, P padded to 10")
    for rr in range(2):
        a, b = [r for r in ranks if int(r["coords"][0]) == rr]
        check(all(np.array_equal(a[k], b[k]) for k in
                  ("best_z", "best_cost", "best_index")),
              f"(o2) both ranks of robots row {rr} return the same winners")
    ms2 = [float(r["ms"]) for r in ranks]
    log(f"[{card}] (o2) 2x2 mesh step, four processes on one card (gloo, "
        f"host staging), per rank median of 20 (not gated): "
        f"{[round(m, 3) for m in ms2]} ms; spawn to results {spawn_s:.2f} s; "
        f"bitwise {bitwise2}")

    # ---- (o3) the port's dryrun ------------------------------------------
    t = time.perf_counter()
    dry = mesh.dryrun_multichip(4, device=dev)
    check(dry["backend"] == "fused" and dry["staging"] == "host"
          and dry["dist_backend"] == "gloo",
          f"(o3) dryrun_multichip(4) on one card: {dry['dist_backend']}, "
          f"backend {dry['backend']}, staging {dry['staging']}, finite costs "
          f"({time.perf_counter() - t:.2f} s)")
    log(f"(o) mesh phases took {time.perf_counter() - t_phase:.2f} s")
    n_problems = B_MAIN * P
    return dict(launches=launches, err=err, ms=f_ms, plain_ms=plain_ms,
                flops=roofline.sqp_flops(n_problems, BENCH_SCHEDULE),
                n_bytes=roofline.tensor_bytes(fleet_P(flat[0]), *flat[1:],
                                              flat[2]) + 8 * n_problems)


def host_layers_phase(tick_scene, metrics_log):
    """(o4) The host layers on the card's run: the terminal dashboard and
    the web snapshot of the multi-robot phase's MetricsLog, and
    ``Planner.visualize`` and ``SceneRecorder.capture`` on the tick phase's
    planner (its last serial tick)."""
    import tempfile

    from oscar_mpc_planner_mr_modification_tpu_torch.dashboard import (
        render_dashboard)
    from oscar_mpc_planner_mr_modification_tpu_torch.dashboard_web import (
        snapshot)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils.visualization import (  # noqa: E501
        SceneRecorder)

    text = render_dashboard(metrics_log)
    snap = snapshot(metrics_log)
    robots = sorted(metrics_log.records)
    log("(o4) dashboard of the multi-robot run:\n" + text)
    check([r["ns"] for r in snap["robots"]] == robots
          and all(ns in text for ns in robots),
          f"(o4) dashboard and snapshot list the robots {robots}")
    planner, guidance, t, state, data, out = tick_scene
    check(planner.visualize(state, data) is None,
          "(o4) Planner.visualize on the tick planner returns None")
    rec = SceneRecorder()
    frame = rec.capture(t, state, data, planner=planner, output=out,
                        guidance=guidance)
    with tempfile.TemporaryDirectory() as work:
        payload = json.load(open(rec.save_json(os.path.join(work, "s.json"))))
    check(len(payload) == 1 and np.all(np.isfinite(frame.robot_pose))
          and frame.warmstart_trajectory.shape == (N_MAIN + 1, 2),
          f"(o4) SceneRecorder.capture on the tick planner: pose "
          f"{np.round(frame.robot_pose, 3).tolist()}, "
          f"{len(frame.obstacles)} obstacles, "
          f"{len(frame.guidance_trajectories)} guidance trajectories, "
          f"planned {frame.planned_trajectory is not None}")


# ---------------------------------------------------------------------------
# (p) The repository's runnable entry points on the port
# ---------------------------------------------------------------------------
#: Seconds each robot process of the fleet-process demo ticks here (the
#: demo's own default is 20).
ENTRY_FLEET_SECONDS = 5.0


def bench_skeleton_keys():
    """The keys of bench.py's skeleton line, read from its source (the JAX
    bench is not run)."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py holds no skeleton dict")


def entrypoints_phase(dev, card, reset_counts, counts, none, fleet_b2_ms):
    """(p) The port's runnable entry points, in this process on the kernels
    built above, each checked and printed: (p1) ``tools/bench.py`` at full
    size (512 x 9, N=20, f32, ``"fused"``): its first line the skeleton
    with every key of bench.py's, its last line every key, no -1 but
    ``vs_baseline``, success >= 0.95, one B2 launch and no other kernel per
    fleet step, the fleet step within 15% of ``fleet_b2_ms`` (B2 at the
    bench shape, timed earlier in this run), ``mfu_chip`` below 1.05; B2 at
    the bench's 72-problem solve and at phase 5's rollout tick against its
    plain version; (p2) ``tools/exp_schedule_hw.py`` at its two default
    schedules; (p3) ``tools/profile_e2e_tick.py`` in both modes; (p4)
    ``tools/validate.py`` (both f32 gates through B1, the f64
    cross-checks, the throughput sample); (p5) the four demos at their card
    sizes (the fleet-process demo's robots tick ``ENTRY_FLEET_SECONDS``),
    each with the launch counts set to 0 before it; (p6)
    ``tools/kernel_check.py``. Returns the two B2 rows' numbers."""
    import contextlib
    import io
    import tempfile

    from oscar_mpc_planner_mr_modification_tpu_torch.examples import (
        demo_fleet_processes, demo_monte_carlo, demo_multirobot,
        demo_single_robot)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import roofline
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.rollout import (
        make_tmpc_rollout, tmpc_scenes)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench, exp_schedule_hw, kernel_check, profile_e2e_tick, validate)

    # (p1) the bench
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(dev, batch=B_MAIN, N=N_MAIN, iters=10, n_paths=N_PATHS,
                   backend="fused")
    lines = buf.getvalue().splitlines()
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    log(f"(p1) tools/bench.py in {time.perf_counter() - t:.1f} s, "
        f"{len(lines)} lines; the last:\n{lines[-1]}")
    keys = bench_skeleton_keys()
    numbers = [k for k, v in first.items() if type(v) is float]
    check(keys <= set(first) and numbers
          and all(first[k] == -1.0 for k in numbers),
          f"(p1) the bench's first line is the skeleton: every key of "
          f"bench.py's ({len(keys)}), its {len(numbers)} measured fields at "
          f"-1")
    left = [k for k, v in last.items()
            if type(v) in (int, float) and v == -1 and k != "vs_baseline"]
    check(keys <= set(last) and not left and last["vs_baseline"] == -1.0
          and last["backend"] == "fused" and last["platform"] == "gpu"
          and last["success_rate"] >= 0.95,
          f"(p1) the bench's last line: every key of bench.py's, no -1 but "
          f"vs_baseline (left: {left}), backend {last['backend']!r}, success "
          f"{last['success_rate']:.4f} >= 0.95")
    check(last["launches"]["fleet_step"] == {"sqp_fused": 1},
          f"(p1) one bench fleet step: launches {last['launches']['fleet_step']}"
          f" (one B2 launch, no other kernel)")
    ratio = last["on_device_fleet_step_ms"] / fleet_b2_ms
    check(abs(ratio - 1.0) <= 0.15,
          f"(p1) the bench's on_device_fleet_step_ms "
          f"{last['on_device_fleet_step_ms']:.3f} within 15% of B2 at the "
          f"bench shape {fleet_b2_ms:.3f} ms (ratio {ratio:.4f})")
    check(0.0 < last["mfu_chip"] < 1.05,
          f"(p1) mfu_chip {last['mfu_chip']:.5f} < 1.05")
    resident = last["launches"]["device_resident"]
    n_res = (bench.RESIDENT_SAMPLES + 1) * (bench.RESIDENT_K + 1)
    check(resident == {"sqp_fused": n_res},
          f"(p1) phase 5's rollouts: launches {resident} (one B2 launch per "
          f"tick, {n_res}, no other kernel)")
    log(f"[{card}] (p1) bench: {last['value']:.1f} plans/s (host clock), "
        f"device {last['device_plans_per_s']:.1f} plans/s, fleet step "
        f"{last['on_device_fleet_step_ms']:.3f} ms, 72-problem step "
        f"{last['on_device_step_ms']:.3f} ms (host share of a call "
        f"{last['transport_rtt_ms']:.3f} ms), small batch median "
        f"{last['small_batch_median_ms']:.3f} / p99 "
        f"{last['p99_small_batch_latency_ms']:.3f} ms, e2e tick "
        f"[{last['e2e_structure']}] {last['e2e_tick_median_ms']:.3f} / p99 "
        f"{last['e2e_tick_p99_ms']:.3f} ms (host {last['e2e_host_serial_ms']:.3f}"
        f" ms), device-resident tick {last['device_resident_tick_ms']:.3f} "
        f"ms, achieved {last['achieved_tflops']:.4f} TFLOP/s, mfu_chip "
        f"{last['mfu_chip']:.5f}")

    cfg = bench_config()
    ocp_b, args = bench_fleet(B_MAIN, torch.float32, dev, N_MAIN)
    small = tuple(a[:bench.SMALL_B * (N_PATHS + 1)] for a in flat_fleet(args))
    err_s, k_s, p_s, a32_s, _ = b2_against_plain(
        dev, card, ocp_b, cfg, small, "the bench's small batch")
    n_s = small[0].shape[0]
    small_row = dict(
        launches=(last["launches"]["small_batch"]["sqp_fused"]
                  + last["launches"]["on_device_step"]["sqp_fused"]),
        err=err_s, ms=k_s, plain_ms=p_s,
        flops=roofline.sqp_flops(n_s, BENCH_SCHEDULE),
        n_bytes=roofline.tensor_bytes(*a32_s, a32_s[2]) + 8 * n_s)
    rollout, ocp_r = make_tmpc_rollout(
        n_obstacles=bench.RESIDENT_OBS, N=N_MAIN, n_ticks=1, n_paths=N_PATHS,
        config=cfg, dtype=torch.float32, backend="fused", device=dev)
    scenes = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in tmpc_scenes(bench.RESIDENT_B, bench.RESIDENT_OBS,
                                        seed=0))
    P_r = rollout.first_tick_params(*scenes).reshape(-1, N_MAIN, ocp_r.npar)
    Z_r = rollout.first_tick_seeds(*scenes).reshape(-1, N_MAIN + 1,
                                                    ocp_r.nvar)
    err_r, k_r, p_r, a32_r, mach_r = b2_against_plain(
        dev, card, ocp_r, cfg, (P_r, Z_r[:, 0, ocp_r.nu:], Z_r),
        "phase 5's rollout tick")
    check_ip_count(mach_r, ocp_r, "TICK", "phase 5's rollout (the tick's OCP)")
    n_r = P_r.shape[0]
    rollout_row = dict(
        launches=resident["sqp_fused"], err=err_r, ms=k_r, plain_ms=p_r,
        flops=roofline.sqp_flops(n_r, BENCH_SCHEDULE,
                                 lin=roofline.TICK_LIN_FLOPS,
                                 merit=roofline.TICK_MERIT_FLOPS,
                                 ip_iter=roofline.TICK_IP_ITER_FLOPS),
        n_bytes=roofline.tensor_bytes(*a32_r, a32_r[2]) + 8 * n_r)

    # (p2) the schedule sweep
    t = time.perf_counter()
    reset_counts()
    rows = exp_schedule_hw.sweep()
    got = counts()
    n_solves = len(rows) * (1 + 2 + exp_schedule_hw.REPS)
    check(got == {**none, "sqp_fused": n_solves},
          f"(p2) schedule sweep: launches {got} (one B2 per solve, "
          f"{n_solves})")
    for r in rows:
        log(f"[{card}] (p2) schedule {r['label']}: success {r['success']:.4f},"
            f" plan success {r['plan_success']:.4f}, fleet step "
            f"{r['step_ms']:.3f} ms ({r['plans_per_s']:.1f} plans/s)")
        check(r["step_ms"] > 0.0 and r["plan_success"] > 0.0,
              f"(p2) schedule {r['label']} ran")
    log(f"(p2) in {time.perf_counter() - t:.1f} s")

    # (p3) the tick's host profile, both modes
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out3:
        prof = profile_e2e_tick.main(dev)
        host = profile_e2e_tick.host_only(dev, profile=False)
    log(f"[{card}] (p3) profile_e2e_tick: ticks median "
        f"{prof['median_ms']:.3f} ms (p90 {prof['p90_ms']:.3f}) under "
        f"cProfile, host {prof['host_median_ms']:.3f}; HOST_ONLY: host median "
        f"{host['host_median_ms']:.3f} ms (p90 {host['host_p90_ms']:.3f}), "
        f"tick {host['tick_median_ms']:.3f} ms; in "
        f"{time.perf_counter() - t:.1f} s; the profile's first lines:\n"
        + "\n".join(prof["stats"].splitlines()[:16]))
    check(len(out3.getvalue()) > 0 and 0.0 < host["host_median_ms"]
          < host["tick_median_ms"] * 1.01,
          "(p3) profile_e2e_tick printed, host median within the tick")

    # (p4) validate
    t = time.perf_counter()
    reset_counts()
    summary = validate.run(dev)
    got = counts()
    log(f"[{card}] (p4) tools/validate.py in {time.perf_counter() - t:.1f} s: "
        f"{summary}; launches {got}")
    check(summary["ok"] and got["qp_ip"] > 0 and got["sqp_fused"] == 0
          and got["sqp_single"] == len(GATE_FLAVOURS),
          "(p4) validate: both f32 gates through B1 pass, each f64 "
          "cross-check one S1 launch")

    # (p5) the demos
    with tempfile.TemporaryDirectory() as work:
        t = time.perf_counter()
        reset_counts()
        single = demo_single_robot.main(dev, out_dir=work)
        got = counts()
        log(f"[{card}] (p5) demo_single_robot in "
            f"{time.perf_counter() - t:.1f} s: {single}; launches {got}")
        check(os.path.isfile(single["json"]) and single["png"] is None
              and got == {**none, "sqp_fused": single["steps"]},
              "(p5) demo_single_robot wrote its scene log, one B2 launch per "
              "tick")
    t = time.perf_counter()
    reset_counts()
    mc = demo_monte_carlo.main(dev)
    got = counts()
    want = (len(mc["rows"]) + 1) * demo_monte_carlo.N_TICKS
    log(f"[{card}] (p5) demo_monte_carlo in {time.perf_counter() - t:.1f} s: "
        f"{mc}; launches {got}")
    check(got == {**none, "sqp_fused": want},
          f"(p5) demo_monte_carlo: one B2 launch per rollout tick ({want})")
    t = time.perf_counter()
    reset_counts()
    mr = demo_multirobot.main(dev)
    got = counts()
    log(f"[{card}] (p5) demo_multirobot in {time.perf_counter() - t:.1f} s: "
        f"{mr}; launches {got}")
    check(all(r["cycles"] > 0 for r in mr.values())
          and got == {**none, "sqp_fused": got["sqp_fused"]}
          and got["sqp_fused"] > 0,
          "(p5) demo_multirobot: every robot planned, B2 alone")
    t = time.perf_counter()
    fleet = demo_fleet_processes.main(dev, seconds=ENTRY_FLEET_SECONDS)
    log(f"[{card}] (p5) demo_fleet_processes (the JAX demo's robots: N=10, "
        f"f64, 4 x 8, mirror, S1) in {time.perf_counter() - t:.1f} s: "
        f"{fleet}")
    check(len(fleet) == 3 and all(r["ticks"] > 0 and r["solves"] > 0
                                  and r["launches"] == r["solves"]
                                  for r in fleet.values()),
          "(p5) demo_fleet_processes: three robot processes ticked and "
          "joined, one S1 launch per planning solve")
    demo_launches = sum(r["launches"] for r in fleet.values())
    demo_row = s1_against_plain(
        dev, card, *_demo_args(), roofline.S1_DEMO, "the fleet-process "
        "demo's robot", demo_launches)

    # (p6) the kernels against their plain versions on small fleets
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out6:
        rc = kernel_check.main()
    log(f"(p6) tools/kernel_check.py in {time.perf_counter() - t:.1f} s: "
        f"{out6.getvalue().strip()}")
    check(rc == 0, "(p6) kernel_check: every f64 gate holds")
    return dict(small=small_row, rollout=rollout_row, demo=demo_row)


def _demo_args():
    """(ocp, config, numpy args) of the fleet-process demo robot's S1
    check: ``tools/common.py::goal_demo_problem(10)`` at the robot's SQP."""
    from oscar_mpc_planner_mr_modification_tpu_torch.examples import (
        demo_fleet_processes)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
        goal_demo_problem)

    ocp, *args = goal_demo_problem(10)
    return ocp, SQPConfig(**demo_fleet_processes.ROBOT_SQP), args


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"ok: {msg}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _LAP_T[0] = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline, sqp_fused, sqp_single)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        QPData, SQPConfig, make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        make_batched_tmpc_step)

    # ---- 1. environment -------------------------------------------------
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([qp_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    lap("1 environment")
    # ---- 2. build (one nvcc per kernel source, all started together) ------
    t = time.perf_counter()
    infos = qp_cuda.build_all()
    qp_cuda._library()
    sqp_fused._library()
    roofline._library()
    sqp_single._library()
    build_s = time.perf_counter() - t
    log(f"built {len(infos)} kernel libraries in {build_s:.2f} s")
    for name, info in infos.items():
        log(f"{name}: {os.path.relpath(info.path, ROOT)} (nvcc {info.seconds:.2f} s)")
        for line in info.log.splitlines():
            if "entry function" in line or "Function properties for" in line:
                log(f"ptxas {name}: {line.strip()}")
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    b2_ptxas = {}
    for name, v in ptxas_entries(infos["sqp_fused"].log).items():
        m = re.search(r"sqp_fused_kernelI([fd])N4tmpc\d+(\w+?)EE", name)
        if m:
            b2_ptxas[f"{m.group(1)} {m.group(2)}"] = v
    if infos["sqp_fused"].log:
        check(b2_ptxas == B2_PTXAS, f"B2's solve kernels: (registers, stack "
              f"bytes) per dtype and model {b2_ptxas} = the parent's build's "
              f"(the mirror variant is compiled in sqp_linearize_mirror.cu "
              f"alone)")
    else:
        log("B2's library was reused from an earlier build: its ptxas "
            "report is not in this run")
    log_launch_plans(dev)

    lap("2 build")
    # ---- 3. kernel against the plain version (B=64 -> 576 problems) -------
    cfg = bench_config()
    qp64, mach64 = initial_qp(64, torch.float64, dev)
    _, dz64, diff, _ = compare(qp64, mach64, 8, cfg)
    scale = 1.0 + dz64.abs().max().item()
    log(f"f64 576 problems: max|dz| {dz64.abs().max().item():.6e}, "
        f"max|ddz| {diff.max().item():.6e}, median |ddz| "
        f"{diff.median().item():.6e}")
    check(diff.max().item() <= QP_F64_GATE * scale,
          f"f64 kernel = plain: max|ddz| <= {QP_F64_GATE:g} (1 + max|dz|) = "
          f"{QP_F64_GATE * scale:.3e}")

    qp32, mach32 = initial_qp(64, torch.float32, dev)
    dz_k, dz_p, diff, rel = compare(qp32, mach32, 8, cfg)
    log(f"f32 576 problems: max|ddz| {diff.max().item():.6e}, median |ddz| "
        f"{diff.median().item():.6e}, median rel {rel.median().item():.6e}")
    check(rel.median().item() <= 1e-4,
          "f32 kernel = plain: median over problems of max|ddz| / (1 + max|dz|) <= 1e-4")
    check(bool(torch.isfinite(dz_k)[torch.isfinite(dz_p)].all()),
          "f32 kernel dz finite wherever the plain dz is")
    # Where the two f32 solves part, both part from the f64 solution: solve
    # the f64 QPs rounded to f32 both ways and hold each against it.
    qp_r = type(qp64)(*(x.float() for x in qp64))
    dz_k, dz_p, _, _ = compare(qp_r, mach64, 8, cfg)
    for name, dz in (("kernel", dz_k), ("plain", dz_p)):
        err = (dz.double() - dz64).abs().amax(dim=(1, 2))
        log(f"f32 {name} vs f64 solution on the rounded QPs: max "
            f"{err.max().item():.6e}, p99 {err.quantile(0.99).item():.6e}, "
            f"median {err.median().item():.6e}")

    lap("3 B1 vs plain")
    # ---- 4. f64 golden: contouring_2obs ----------------------------------
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    gold = np.load(os.path.join(ROOT, "tests", "golden", "contouring_2obs.npz"))
    settings = default_settings(N=15, max_obstacles=2)
    ocp_g = build_ocp(*configuration_basic(settings), settings)
    check(ocp_g.npar == 69, f"configuration_basic npar = {ocp_g.npar} == 69")
    solve_g = make_fleet_sqp_solver(
        ocp_g, SQPConfig(n_sqp=30, n_qp_iter=20, mu_min=1e-10,
                         regularization="mirror", track_best=True),
        dtype=torch.float64, device=dev)
    n0 = qp_cuda.launches
    res_g = solve_g(gold["P"][None], gold["x0"][None], gold["z_init"][None])
    torch.cuda.synchronize()
    zerr = float(np.abs(res_g.z[0].cpu().numpy() - gold["Z"]).max())
    cost_g = float(res_g.cost[0])
    log(f"golden: max|Z - Z_gold| {zerr:.6e}, cost {cost_g:.12f} vs "
        f"{float(gold['cost']):.12f}, eq_res {float(res_g.eq_res[0]):.3e}, "
        f"kernel launches {qp_cuda.launches - n0}")
    check(qp_cuda.launches - n0 == 30, "golden solve ran 30 kernel launches")
    check(bool(res_g.success[0]), "golden solve succeeded")
    check(zerr <= 1e-4, "golden Z within atol 1e-4")
    check(abs(cost_g - float(gold["cost"])) <= 1e-5 * abs(float(gold["cost"])),
          "golden cost within rtol 1e-5")

    lap("4 golden (pallas)")
    # ---- 5. fused kernel: in-kernel linearization vs torch.func (576) -----
    lin_err = 0.0
    for dtype in (torch.float64, torch.float32):
        ocp64, args64 = bench_fleet(64, dtype, dev)
        fused64 = make_fleet_sqp_solver(ocp64, cfg, dtype=dtype, device=dev,
                                        backend="fused")
        P64, x64, z64 = flat_fleet(args64)
        lin_args = (fleet_P(P64), x64, z64)
        got = sqp_fused.linearize(fused64.tables, *lin_args)
        want = sqp_fused.linearize_reference(fused64.machinery, fused64.tables,
                                             *lin_args)
        torch.cuda.synchronize()
        names = QPData._fields + ("merit", "cost", "eq_res")
        flat_got = tuple(got[0]) + tuple(got[1:])
        flat_want = tuple(want[0]) + tuple(want[1:])
        worst = []
        for name, a, b in zip(names, flat_got, flat_want):
            rel = (a - b).abs() / (1.0 + b.abs())
            if dtype == torch.float64:
                lin_err = max(lin_err, (a - b).abs().max().item())
            log(f"{str(dtype)[6:]} linearize {name}: max|d| "
                f"{(a - b).abs().max().item():.3e}, median |d|/(1+|ref|) "
                f"{rel.median().item():.3e}, max|ref| {b.abs().max().item():.3e}")
            if dtype == torch.float64:
                if not torch.allclose(a, b, rtol=LIN_F64_RTOL,
                                      atol=LIN_F64_ATOL):
                    worst.append(name)
            elif rel.median().item() > 1e-4:
                worst.append(name)
        if dtype == torch.float64:
            check(not worst, "f64 in-kernel linearization = build_qp on every "
                  f"field within rtol {LIN_F64_RTOL:g}, atol "
                  f"{LIN_F64_ATOL:g} (failed: {worst})")
        else:
            check(not worst, "f32 in-kernel linearization = build_qp: median "
                  f"|d|/(1+|ref|) <= 1e-4 on every field (failed: {worst})")

    lap("5 B2 linearization")
    # ---- 6. fused kernel vs its plain version at f64 (576 problems) ------
    ocp64, args64 = bench_fleet(64, torch.float64, dev)
    fused_err = 0.0
    for track_best in (False, True):
        fused64 = make_fleet_sqp_solver(
            ocp64, cfg._replace(track_best=track_best), dtype=torch.float64,
            device=dev, backend="fused")
        res_k = fused64(*flat_fleet(args64))
        res_p = fused64.reference(*flat_fleet(args64))
        torch.cuda.synchronize()
        diff = (res_k.z - res_p.z).abs()
        rel = diff.amax(dim=(1, 2)) / (1.0 + res_p.z.abs().amax(dim=(1, 2)))
        fused_err = max(fused_err, diff.max().item())
        log(f"f64 fused solve, track_best={track_best}: success "
            f"{res_k.success.float().mean().item():.6f} (plain "
            f"{res_p.success.float().mean().item():.6f}), max|dZ| "
            f"{diff.max().item():.3e}, max rel {rel.max().item():.3e}, "
            f"max|dcost| {(res_k.cost - res_p.cost).abs().max().item():.3e}")
        check(bool((res_k.success == res_p.success).all()),
              f"f64 fused kernel success mask = plain (track_best={track_best})")
        check(rel.max().item() <= FUSED_F64_GATE,
              "f64 fused kernel = plain: per problem max|dZ| / (1 + max|Z|) "
              f"<= {FUSED_F64_GATE:g}")

    lap("6 B2 vs plain")
    # ---- 7. main path at full width: backend="fused" ----------------------
    ocp, args = bench_fleet(B_MAIN, torch.float32, dev)
    step = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32, device=dev,
                                  backend="fused")
    qp_cuda.launches = sqp_fused.launches = 0
    out = step(*args)
    torch.cuda.synchronize()
    fused_launches, b1_in_fused = sqp_fused.launches, qp_cuda.launches
    check(fused_launches == 1 and b1_in_fused == 0,
          f"fused fleet step: {fused_launches} fused launch(es) (want 1), "
          f"{b1_in_fused} QP-kernel launches (want 0)")
    P = N_PATHS + 1
    check(tuple(out.best_z.shape) == (B_MAIN, N_MAIN + 1, ocp.nvar)
          and bool(torch.isfinite(out.best_z).all()),
          f"best_z finite, shape {tuple(out.best_z.shape)}")
    success_rate = out.any_success.float().mean().item()
    per_planner = out.all_success.float().mean(dim=0).cpu().numpy()
    log(f"fused step: success_rate (best-of-{P}) {success_rate:.6f}; per "
        f"planner {np.array2string(per_planner, precision=4)}; mean "
        f"{per_planner.mean():.6f}")
    check(success_rate >= 0.95, "fused step: best-of-9 success_rate >= 0.95")

    def agreement(other, name):
        agree = (out.any_success == other.any_success).float().mean().item()
        both = out.any_success & other.any_success
        rel_cost = ((out.best_cost - other.best_cost).abs()
                    / other.best_cost.abs().clamp(min=1e-12))[both]
        log(f"{name}: success_rate "
            f"{other.any_success.float().mean().item():.6f}, any_success "
            f"agreement with the fused step {agree:.6f}, median rel best_cost "
            f"diff {rel_cost.median().item():.6e}")
        check(agree >= 0.99,
              f"fused step any_success agrees with the {name} on >= 99% of plans")

    with plain_fused_solver(step.fleet_solve):
        n0 = sqp_fused.launches + qp_cuda.launches
        out_pf = step(*args)
        torch.cuda.synchronize()
        check(sqp_fused.launches + qp_cuda.launches == n0,
              "plain fused step launched no kernel")
    agreement(out_pf, "plain fused step")

    lap("7 fused step")
    # ---- 8. the per-iteration path at full width: backend="pallas" -------
    step_b1 = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32, device=dev,
                                     backend="pallas")
    qp_cuda.launches = sqp_fused.launches = 0
    out_b1 = step_b1(*args)
    torch.cuda.synchronize()
    main_launches = qp_cuda.launches
    n_sqp = sum(n for n, _ in BENCH_SCHEDULE)
    check(main_launches == n_sqp and sqp_fused.launches == 0,
          f"per-iteration fleet step launched the QP kernel {main_launches} "
          f"times (one per SQP iteration, {n_sqp}) and the fused kernel "
          f"{sqp_fused.launches} times (want 0)")
    b1_success = out_b1.any_success.float().mean().item()
    check(b1_success >= 0.95, "per-iteration step: best-of-9 success_rate >= 0.95")
    agreement(out_b1, "per-iteration (QP kernel) step")
    with plain_qp_solver():
        n0 = qp_cuda.launches
        out_p = step_b1(*args)
        torch.cuda.synchronize()
        check(qp_cuda.launches == n0, "plain per-iteration step launched no kernel")
    agree = (out_b1.any_success == out_p.any_success).float().mean().item()
    log(f"plain per-iteration step: any_success agreement with the "
        f"per-iteration step {agree:.6f}")
    check(agree >= 0.99, "per-iteration step any_success agrees with its plain "
          "step on >= 99% of plans")

    lap("8 pallas step")
    # ---- 9. times ----------------------------------------------------------
    step_ms, step_all = cuda_time_ms(lambda: step(*args), reps=10)
    b1_step_ms, _ = cuda_time_ms(lambda: step_b1(*args), reps=5, warmup=1)
    with plain_fused_solver(step.fleet_solve):
        plain_fused_ms, _ = cuda_time_ms(lambda: step(*args), reps=1, warmup=0)
    with plain_qp_solver():
        plain_step_ms, _ = cuda_time_ms(lambda: step_b1(*args), reps=1,
                                        warmup=0)
    log(f"[{card}] fleet step (B={B_MAIN} x {P} planners, N={N_MAIN}, f32), "
        f"median of 10 / 5, plain one run each: fused kernel path "
        f"{step_ms:.3f} ms = "
        f"{B_MAIN / step_ms * 1e3:.1f} plans/s; per-iteration (QP kernel) "
        f"path {b1_step_ms:.3f} ms = {B_MAIN / b1_step_ms * 1e3:.1f} plans/s; "
        f"plain fused path {plain_fused_ms:.3f} ms = "
        f"{B_MAIN / plain_fused_ms * 1e3:.1f} plans/s; plain per-iteration "
        f"path {plain_step_ms:.3f} ms = {B_MAIN / plain_step_ms * 1e3:.1f} "
        f"plans/s; fused step {spread(step_all)}")
    flat = flat_fleet(args)
    f_ms, f_all = cuda_time_ms(lambda: step.fleet_solve(*flat), reps=10)
    fp_ms, _ = cuda_time_ms(lambda: step.fleet_solve.reference(*flat), reps=1,
                            warmup=0)
    log(f"[{card}] fused solve at the bench shape ({B_MAIN * P} problems, "
        f"T={N_MAIN + 1}, schedule {BENCH_SCHEDULE}, f32): kernel {f_ms:.3f} "
        f"ms per launch (median of 10; {spread(f_all)}), plain "
        f"fused_fleet_reference {fp_ms:.3f} ms (one run)")
    check(f_ms <= B2_BENCH_MS[1] * 1.1, f"B2 at the bench shape {f_ms:.3f} "
          f"ms within 10% of its row's range {B2_BENCH_MS} ms (PERF.md)")
    lin_in = (fleet_P(flat[0]), flat[1], flat[2])
    l_ms, _ = cuda_time_ms(
        lambda: sqp_fused.linearize(step.fleet_solve.tables, *lin_in), reps=10)
    log(f"[{card}] fused kernel's linearization alone (sqp_fused_linearize "
        f"entry plus unpacking) at the bench shape, f32: {l_ms:.3f} ms per "
        f"call (median of 10)")
    n_dev, busy_ms, wall_ms = profile_step(step, args)
    log(f"[{card}] torch.profiler, one fused step: {n_dev} device ops, device "
        f"busy {busy_ms:.3f} ms, profiled wall {wall_ms:.3f} ms; idle share "
        f"{1 - busy_ms / wall_ms:.4f} (profiled), "
        f"{1 - busy_ms / step_ms:.4f} (against the unprofiled step)")

    qpb, machb = initial_qp(B_MAIN, torch.float32, dev)
    dz_k, dz_p, diff, rel = compare(qpb, machb, 8, cfg)
    max_abs_err = diff.max().item()
    log(f"bench-shape QP ({qpb.H.shape[0]} problems, T={qpb.H.shape[1]}, "
        f"m={qpb.D.shape[2]}, 8 iterations, f32): max|ddz| {max_abs_err:.6e}, "
        f"median rel {rel.median().item():.6e}")
    check(rel.median().item() <= 1e-4, "bench-shape f32 kernel = plain (median rel <= 1e-4)")
    kw = dict(nu=machb.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
              row_meta=machb.row_meta)
    k_ms, k_all = cuda_time_ms(
        lambda: qp_cuda.solve_qp_batched(*qp_args(qpb, machb), **kw), reps=20)
    p_ms, _ = cuda_time_ms(
        lambda: qp_cuda.ip_solve_reference(*qp_args(qpb, machb), **kw), reps=1,
        warmup=0)
    log(f"[{card}] IP solve per launch at the bench shape: kernel {k_ms:.3f} ms "
        f"(median of 20; {spread(k_all)}), plain {p_ms:.3f} ms")
    z0 = args[2].reshape(B_MAIN * P, *args[2].shape[2:])
    p0 = args[0].reshape(B_MAIN * P, *args[0].shape[2:])
    p0 = torch.cat([p0, p0[:, -1:]], dim=1)
    x0 = args[1].repeat_interleave(P, dim=0)
    lin_ms, _ = cuda_time_ms(lambda: machb.build_qp(z0, p0, x0), reps=5)
    log(f"[{card}] linearization (build_qp, torch.func) per SQP iteration at "
        f"the bench shape: {lin_ms:.3f} ms")

    n_problems = B_MAIN * P
    tables = step.fleet_solve.tables
    lin_f = sqp_fused._lanes_in(*lin_in)
    lf_ms, lf_all = cuda_time_ms(
        lambda: sqp_fused.linearize_fields(tables, *lin_f), reps=10)
    lr_ms, _ = cuda_time_ms(
        lambda: sqp_fused.linearize_reference(step.fleet_solve.machinery,
                                              tables, *lin_in), reps=3,
        warmup=1)
    log(f"[{card}] linearize entry alone (sqp_fused_linearize, field-major "
        f"in and out, no unpacking) at the bench shape, f32: {lf_ms:.3f} ms "
        f"per launch (median of 10; {spread(lf_all)}); plain "
        f"linearize_reference {lr_ms:.3f} ms")

    lap("9 times")
    # ---- 10. B1's dual variants vs the plain version at the bench QPs -----
    def gap(a, b):
        """|a - b|, 0 where both are NaN (a NaN on one side stays NaN)."""
        return torch.where(torch.isnan(a) & torch.isnan(b),
                           torch.zeros_like(a), (a - b).abs())

    def duals_pair(qp, mach, n_iters, lam0=None):
        kw = dict(nu=mach.nu, n_iters=n_iters, mu_min=cfg.mu_min,
                  w_max=cfg.w_max, row_meta=mach.row_meta, lam0=lam0)
        got = qp_cuda.solve_qp_batched_duals(*qp_args(qp, mach), **kw)
        want = qp_cuda.ip_solve_reference(*qp_args(qp, mach), duals_out=True,
                                          **kw)
        torch.cuda.synchronize()
        return got, want

    duals_err = 0.0
    for dtype, batch in ((torch.float64, 64), (torch.float32, B_MAIN)):
        mach_d, P_d, x_d, Z_d = bench_qps(batch, dtype, dev)
        cold = duals_pair(mach_d.build_qp(Z_d, P_d, x_d), mach_d, 8)
        dz_d, lam_d = cold[0]
        # The warm start: the QPs re-linearized after the kernel's step, warm
        # from its multipliers (NaN reseeded to 1, as the fleet path does).
        lam_1 = torch.where(torch.isnan(lam_d), torch.ones_like(lam_d), lam_d)
        qp_1 = mach_d.build_qp(Z_d + torch.nan_to_num(dz_d), P_d, x_d)
        warm = duals_pair(qp_1, mach_d, 6, lam0=lam_1)
        for phase, (got, want) in (("cold", cold), ("warm", warm)):
            for name, a, b in zip(("z", "lam"), got, want):
                d = gap(a, b)
                ref = torch.nan_to_num(b).abs()
                rel = d.flatten(1).amax(1) / (1.0 + ref.flatten(1).amax(1))
                scale = 1.0 + ref.max().item()
                log(f"{str(dtype)[6:]} duals {phase} ({a.shape[0]} problems): "
                    f"{name} max|d| {d.max().item():.3e}, max|ref| "
                    f"{scale - 1:.3e}, median rel {rel.median().item():.3e}, "
                    f"NaN {int(torch.isnan(b).sum())}")
                if dtype == torch.float64:
                    check(d.max().item() <= QP_F64_GATE * scale,
                          f"f64 duals kernel = plain ({phase}, {name}): max|d|"
                          f" <= {QP_F64_GATE:g} (1 + max|ref|) = "
                          f"{QP_F64_GATE * scale:.3e}")
                else:
                    check(rel.median().item() <= 1e-4,
                          f"f32 duals kernel = plain ({phase}, {name}): median"
                          f" over problems of max|d| / (1 + max|ref|) <= 1e-4")
                    if name == "z":
                        duals_err = max(duals_err, d.max().item())
    kw_w = dict(nu=mach_d.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
                row_meta=mach_d.row_meta, lam0=lam_1)
    dk_ms, dk_all = cuda_time_ms(lambda: qp_cuda.solve_qp_batched_duals(
        *qp_args(qp_1, mach_d), **kw_w), reps=20)
    dp_ms, _ = cuda_time_ms(lambda: qp_cuda.ip_solve_reference(
        *qp_args(qp_1, mach_d), duals_out=True, **kw_w), reps=1, warmup=0)
    log(f"[{card}] duals/warm IP solve per launch at the bench shape (warm, 8 "
        f"iterations, f32): kernel {dk_ms:.3f} ms (median of 20; "
        f"{spread(dk_all)}), plain {dp_ms:.3f} ms")

    lap("10 B1 duals")
    # ---- 11. path (a): the dual-warm per-iteration fleet step -------------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_roofline, bench_warm)

    def reset_counts():
        qp_cuda.launches = qp_cuda.duals_launches = qp_cuda.warm_launches = 0
        qp_cuda.lanes_launches = sqp_fused.launches = 0
        sqp_fused.linearize_launches = sqp_fused.merit_launches = 0
        sqp_fused.mirror_launches = 0
        roofline.launches = sqp_single.launches = 0

    def counts():
        return {k: v for k, v in launch_counts().items() if k != "fma_roof"}

    none = dict.fromkeys(counts(), 0)
    n_sqp_w = bench_warm.BASE.n_sqp
    warm_ref, warm_ms = None, {}
    for name, wcfg in bench_warm.VARIANTS:
        wstep = make_batched_tmpc_step(ocp, wcfg, dtype=torch.float32,
                                       device=dev, backend="pallas")
        reset_counts()
        wout, warm_ms[name] = timed_once(lambda: wstep(*args))
        got = counts()
        want = ({**none, "duals": n_sqp_w, "warm": n_sqp_w - 1}
                if wcfg.n_qp_iter_warm else {**none, "qp_ip": n_sqp_w})
        check(got == want, f"{name} step (n_sqp={n_sqp_w}, n_qp_iter="
              f"{wcfg.n_qp_iter}, n_qp_iter_warm={wcfg.n_qp_iter_warm}) "
              f"launches {got} (want {want})")
        if name == "warm8":
            warm_launches = got["duals"]
        summ = bench_warm.summary(wout)
        log(f"[{card}] {name} step: {warm_ms[name]:.3f} ms (one run) = "
            f"{B_MAIN / warm_ms[name] * 1e3:.1f} plans/s; success (best-of-"
            f"{P}) {summ['success']:.6f}, per problem "
            f"{summ['success_per_problem']:.6f}")
        check(summ["success"] >= 0.95, f"{name} step: best-of-9 success >= 0.95")
        if warm_ref is None:
            warm_ref = wout
            continue
        vs = bench_warm.against(wout, warm_ref)
        log(f"{name} vs cold: any_success agreement {vs['agreement']:.6f}; "
            f"cost_rel_p99 (per problem both solved, the JAX tool's metric) "
            f"{vs['cost_rel_p99']:.6e}; best_cost_rel_p99 (per plan both "
            f"solved, on the best cost) {vs['best_cost_rel_p99']:.6e}")
        check(vs["agreement"] >= 0.99,
              f"{name} step any_success agrees with the cold step on >= 99%")

    lap("11 dual-warm step")
    # ---- 12. path (b): the lane fleet step, backend="lanes" ---------------
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.linearize import (
        make_lane_linearizer)

    step_ln = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32, device=dev,
                                     backend="lanes")
    mach_ln = step_ln.fleet_solve.machinery
    func_calls = {"build_qp": 0, "merit_of": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            func_calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in func_calls:
        setattr(mach_ln, name, counted(name, getattr(mach_ln, name)))
    reset_counts()
    out_ln = step_ln(*args)
    torch.cuda.synchronize()
    got = counts()
    n_it = sum(n for n, _ in BENCH_SCHEDULE)
    want = {**none, "lanes": n_it, "linearize": n_it, "merit": 1}
    check(got == want and not any(func_calls.values()),
          f"lane step launches {got} (want {want}: a linearize and a QP "
          f"launch per SQP iteration, one merit launch at the end), "
          f"torch.func calls {func_calls} (want none)")
    lanes_launches = got["lanes"]
    lanlin_launches = got["linearize"] + got["merit"]
    ln_success = out_ln.any_success.float().mean().item()
    check(ln_success >= 0.95, "lane step: best-of-9 success_rate >= 0.95")
    agreement(out_ln, "lane step")
    ln_ms, ln_all = cuda_time_ms(lambda: step_ln(*args), reps=10)
    n_dev, busy_ms, wall_ms = profile_step(step_ln, args)
    log(f"[{card}] lane step: {ln_ms:.3f} ms (median of 10; "
        f"{spread(ln_all)}) = {B_MAIN / ln_ms * 1e3:.1f} plans/s; "
        f"torch.profiler, one step: {n_dev} device ops, device busy "
        f"{busy_ms:.3f} ms, profiled wall {wall_ms:.3f} ms; idle share "
        f"{1 - busy_ms / wall_ms:.4f} (profiled), "
        f"{1 - busy_ms / ln_ms:.4f} (against the unprofiled step)")

    lanes_err = 0.0
    for dtype, batch in ((torch.float64, 64), (torch.float32, B_MAIN)):
        ocp_l, fleet_l = bench_fleet(batch, dtype, dev)
        lin = make_lane_linearizer(ocp_l, cfg, dtype=dtype, device=dev)
        P_l, x_l, Z_l = flat_fleet(fleet_l)
        fields, _ = lin.fields(fleet_P(P_l).permute(2, 1, 0).contiguous(),
                               Z_l.permute(1, 2, 0).contiguous(),
                               x_l.t().contiguous())
        kw_l = dict(nu=lin.machinery.nu, n_iters=8, mu_min=cfg.mu_min,
                    w_max=cfg.w_max, row_meta=lin.machinery.row_meta)
        mask_l = lin.machinery.stage_mask
        zk = qp_cuda.solve_qp_fields(fields, mask_l, **kw_l)
        zp = qp_cuda.fields_reference(fields, mask_l, **kw_l)
        torch.cuda.synchronize()
        d = gap(zk, zp)
        ref = torch.nan_to_num(zp).abs()
        rel = d.amax(0) / (1.0 + ref.amax(0))
        scale = 1.0 + ref.max().item()
        log(f"{str(dtype)[6:]} lane QP entry on the linearize buffer "
            f"({zk.shape[1]} problems, 8 iterations): max|d| "
            f"{d.max().item():.3e}, median rel {rel.median().item():.3e}")
        if dtype == torch.float64:
            check(d.max().item() <= QP_F64_GATE * scale,
                  f"f64 lane QP kernel = plain: max|d| <= {QP_F64_GATE:g} "
                  f"(1 + max|ref|) = {QP_F64_GATE * scale:.3e}")
        else:
            check(rel.median().item() <= 1e-4,
                  "f32 lane QP kernel = plain: median rel <= 1e-4")
            lanes_err = d.max().item()
    lk_ms, lk_all = cuda_time_ms(
        lambda: qp_cuda.solve_qp_fields(fields, mask_l, **kw_l), reps=20)
    lp_ms, _ = cuda_time_ms(
        lambda: qp_cuda.fields_reference(fields, mask_l, **kw_l), reps=1,
        warmup=0)
    log(f"[{card}] lane QP entry per launch at the bench shape (8 iterations, "
        f"f32): kernel {lk_ms:.3f} ms (median of 20; {spread(lk_all)}), "
        f"plain {lp_ms:.3f} ms")

    lap("12 lanes step")
    # ---- 12b. (m1) the mirror linearize entry against its plain version ---
    mirror_lin_phase(dev, card)

    lap("12b (m1) mirror entry")
    # ---- 13. path (c): kernel B3, the FP32 roof, achieved FLOP/s ----------
    gen = torch.Generator(device=dev).manual_seed(0)
    x_r = torch.randn(bench_roofline.ROOF_SHAPES[0][0], device=dev,
                      generator=gen)
    y_k = roofline.fma_roof(x_r)
    y_p = roofline.fma_roof_reference(x_r)
    y_e = roofline.fma_roof_emulated(x_r)
    torch.cuda.synchronize()
    fma_err = (y_k - y_p).abs().max().item()
    ulp = (torch.nextafter(y_e, torch.full_like(y_e, float("inf"))) - y_e).abs()
    ulps = ((y_k.double() - y_e.double()).abs() / ulp.double()).max().item()
    same = (y_k == y_e).float().mean().item()
    log(f"B3 at {tuple(x_r.shape)} f32: kernel vs plain max|d| {fma_err:.3e}, "
        f"max rel {((y_k - y_p).abs() / y_p.abs()).max().item():.3e}; vs the "
        f"emulated fmaf recurrence (f64 steps, one rounding to f32 each): "
        f"max {ulps:.3f} ULP, bit-equal share {same:.6f}")
    check(ulps <= 1.0 and same >= 0.999,
          "B3 kernel = emulated fmaf recurrence within 1 ULP, bit-equal on "
          ">= 99.9% of elements (one missing step moves most elements by "
          ">= 2 ULP)")
    check(torch.allclose(y_k, y_p, rtol=FMA_RTOL, atol=1e-6),
          f"B3 kernel = plain within rtol {FMA_RTOL:.3e} (3 roundings of "
          f"2^-24 per step over 256 steps), atol 1e-6")
    fk_ms, _ = cuda_time_ms(lambda: roofline.fma_roof(x_r), reps=10,
                            inner=100)
    fpl_ms, _ = cuda_time_ms(lambda: roofline.fma_roof_reference(x_r), reps=1,
                             warmup=0)
    reset_counts()
    roof = bench_roofline.roof()
    roof_launches = roofline.launches
    check(roof_launches > 0 and counts() == none,
          f"roof measurement launched B3 {roof_launches} times and no other "
          f"kernel ({counts()})")
    mm32 = bench_roofline.matmul_rate(torch.float32)
    mm16 = bench_roofline.matmul_rate(torch.bfloat16)
    peak = roofline.PEAK_FP32_FLOPS / 1e12
    for r in roof["sizes"]:
        log(f"[{card}] B3 roof at {tuple(r['shape'])}: {r['ms']:.6f} ms per "
            f"launch, {r['tflops']:.3f} TFLOP/s ({r['tflops'] / peak:.4f} of "
            f"the published {peak:.0f})")
    log(f"[{card}] measured FP32 roof {roof['tflops']:.3f} TFLOP/s; chained "
        f"2048^3 torch.matmul: f32 (TF32 off) {mm32:.3f} TFLOP/s, bf16 "
        f"{mm16:.3f} TFLOP/s; B3 plain version {fpl_ms:.3f} ms at "
        f"{tuple(x_r.shape)} against {fk_ms:.6f} ms")
    for name, ms in (("fused step", step_ms), ("per-iteration step",
                                               b1_step_ms),
                     ("lane step", ln_ms)):
        a = bench_roofline.achieved(ms, n_problems, roof["tflops"])
        log(f"[{card}] {name} achieved: {a['algo_tflops']:.4f} TFLOP/s by the "
            f"JAX bench's count ({a['algo_share_of_roof']:.5f} of the roof, "
            f"{a['algo_share_of_peak']:.5f} of {peak:.0f}); "
            f"{a['full_tflops']:.4f} TFLOP/s by the full count "
            f"({a['full_share_of_roof']:.5f} of the roof)")
    for name, flops, ms in (
            ("B1 (8 IP iterations)", roofline.ip_flops(n_problems, 8), k_ms),
            ("B2 (the whole solve)",
             roofline.sqp_flops(n_problems, BENCH_SCHEDULE), f_ms)):
        tf = flops / ms / 1e9
        log(f"[{card}] {name} achieved {tf:.4f} TFLOP/s = "
            f"{tf / roof['tflops']:.5f} of the measured roof, "
            f"{tf / peak:.5f} of {peak:.0f} TFLOP/s")

    lap("13 B3 roof")
    # ---- 14. the planner tick: Planner -> TMPCOptimizer -> one B2 --------
    tk = tick_phase(dev, card, reset_counts, counts, none)
    lap("14 tick")
    # ---- 14b. (m2) the settings-built tick: "mirror" on the lane path ----
    mt = mirror_tick_phase(dev, card, reset_counts, counts, none)

    lap("14b (m2) settings-built tick")
    # ---- 15-18. the single-instance solve and BASELINE config 2 ----------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_rollout import (  # noqa: E501
        evaluators)

    evs = evaluators(N=ROLLOUT_N, n_ticks=ROLLOUT_TICKS)
    golden_z, s1_golden = golden_single_phase(dev, card, reset_counts, counts,
                                              none)
    lap("(a) S1 golden")
    gate = baseline_gate_phase(dev, card, reset_counts, counts, none,
                               "contouring", golden_z)
    lap("15 contouring gate")
    s1_basic = basic_tick_phase(dev, card, reset_counts, counts, none)
    lap("(c) basic tick")
    s1_xla = xla_fleet_phase(dev, card, reset_counts, counts, none)
    lap("(c2) xla step")
    ro = evaluator_phase(dev, card, reset_counts, counts, none,
                         evs["contouring"], short_ticks=5,
                         f32_share=F32_ROLLOUT_SHARE)
    lap("18 contouring evaluator")

    # ---- 19-22. BASELINE config 1 and the other evaluators ---------------
    goal_gate = baseline_gate_phase(dev, card, reset_counts, counts, none,
                                    "goal")
    lap("19 goal gate")
    goal_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                              evs["goal"])
    lap("20 goal evaluator")
    mr_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                            evs["multirobot"],
                            f64_gate=COUPLED_F64_ROLLOUT_GATE)
    lap("21 multi-robot evaluator")
    triggered_phase(dev, card, reset_counts, counts, none, evs["multirobot"])
    lap("21b triggered")
    tmpc_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                              evs["tmpc"], f64_gate=COUPLED_F64_ROLLOUT_GATE)
    lap("22 T-MPC evaluator")

    # ---- 23-27. BASELINE configs 3 (CC-MPC) and 5 (SH-MPC) -------------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    cases = matrix_phase(dev, card, reset_counts, counts, none)
    lap("23 matrix")
    cc = fleet_flavour_phase(dev, card, reset_counts, counts, none, "CC-MPC",
                             cases["ccmpc"][0], cases["ccmpc"][1:], "CCMPC")
    lap("24 CC-MPC fleet")
    ocp6, *arrays6 = bench_matrix.build_ccmpc(
        N_MAIN, CONFIG3_B, np.random.default_rng(0), CONFIG3_OBS)
    cc3 = fleet_flavour_phase(dev, card, reset_counts, counts, none,
                              "CC-MPC at config 3's size", ocp6, arrays6,
                              "CCMPC6", b1=False)
    lap("25 CC-MPC config 3")
    cc_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                            evs["ccmpc"])
    lap("26 CC-MPC evaluator")
    ccmpc_margin_phase(dev, card, evs)
    lap("26b CC-MPC margin")
    sh = fleet_flavour_phase(dev, card, reset_counts, counts, none, "SH-MPC",
                             cases["shmpc"][0], cases["shmpc"][1:], "SHMPC")
    lap("27 SH-MPC fleet")
    sh_tick = shmpc_tick_phase(dev, card, reset_counts, counts, none)
    lap("27b SH-MPC ticks, (m3)")

    # ---- 28-30. the multi-robot driver, the dynamic velocity reference,
    # the configuration sweep ---------------------------------------------
    mr_tick = multirobot_phase(dev, card, reset_counts, counts, none)
    lap("28 multi-robot")
    vref = dynvref_phase(dev, card, reset_counts, counts, none)
    lap("29 dyn-vref")
    lmpcc = sweep_phase(dev, card, reset_counts, counts, none)
    lap("30 sweep")

    # ---- 31-33. the bicycles, the curvature-aware unicycle, decomp and
    # road width -----------------------------------------------------------
    bicycles = bicycle_phase(dev, card, reset_counts, counts, none)
    lap("31 bicycles")
    ca = ca_phase(dev, card, reset_counts, counts, none)
    lap("32 CA")
    dec = decomp_phase(dev, card, reset_counts, counts, none)
    lap("33 decomp")

    # ---- 34-35. the sharded fleet step and the host layers ---------------
    mesh_b2 = mesh_phase(dev, card, reset_counts, counts, none)
    lap("34 (o) mesh")
    host_layers_phase(tk["scene"], mr_tick["metrics_log"])
    lap("35 host layers")

    # ---- 36. the runnable entry points -----------------------------------
    ep = entrypoints_phase(dev, card, reset_counts, counts, none, f_ms)
    lap("36 (p) entry points")

    # ---- the kernels, each with its bound ---------------------------------
    def entry(name, source, replaces, launches, err, ms, plain_ms, flops,
              n_bytes, peak=roofline.PEAK_FP32_FLOPS, **_):
        bound, by = roofline.bound_ms(flops, n_bytes, peak)
        return {"name": name, "route": "cuda",
                "source": f"oscar_mpc_planner_mr_modification_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}

    jax_ops = "oscar_mpc_planner_mr_modification_tpu/ops"
    T_b, nx_b, m_b = N_MAIN + 1, qpb.A.shape[-1], qpb.D.shape[2]
    qp_b = roofline.qp_bytes(T_b, nx_b, machb.nu, m_b, tables.mh, n_problems,
                             4)
    ip_it = roofline.ip_iter_flops(machb.row_meta, machb.stage_mask, nx_b,
                                   machb.nu)
    check(ip_it == roofline.IP_ITER_FLOPS,
          f"IP iteration count at this run's rows and mask {ip_it} = "
          f"IP_ITER_FLOPS {roofline.IP_ITER_FLOPS}")
    ip8 = roofline.ip_flops(n_problems, 8)
    lin_b = roofline.tensor_bytes(*lin_in) + 4 * n_problems * (
        sqp_fused.qp_layout(T_b, m_b, tables.mh, tables.nx,
                            tables.nu)["total"] + 3)
    lap("the kernels' bounds")
    print(json.dumps({"phase_seconds": PHASE_S, "build_seconds": round(
        build_s, 3), "nvcc_seconds": {name: round(info.seconds, 3)
                                      for name, info in infos.items()},
        "total_seconds": round(sum(PHASE_S.values()), 3)}), flush=True)
    print(json.dumps({"kernels": [
        entry("qp_ip", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              main_launches, max_abs_err, k_ms, p_ms, ip8, qp_b),
        entry("qp_ip_duals", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:757",
              warm_launches, duals_err, dk_ms, dp_ms, ip8,
              roofline.qp_bytes(T_b, nx_b, machb.nu, m_b, tables.mh,
                                n_problems, 4, lam_in=True, lam_out=True)),
        entry("qp_ip_lanes", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:794",
              lanes_launches, lanes_err, lk_ms, lp_ms, ip8, qp_b),
        entry("sqp_fused", "sqp_fused.cu", f"{jax_ops}/sqp_fused.py:45",
              fused_launches, fused_err, f_ms, fp_ms,
              roofline.sqp_flops(n_problems, BENCH_SCHEDULE),
              roofline.tensor_bytes(*lin_in, flat[2]) + 8 * n_problems),
        entry("sqp_fused_linearize", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", lanlin_launches, lin_err, lf_ms,
              lr_ms, roofline.lin_flops(n_problems), lin_b),
        entry("fma_roof", "fma_roof.cu", "tools/bench_roofline.py:85",
              roof_launches, fma_err, fk_ms, fpl_ms,
              roofline.fma_flops(x_r.numel()), 8 * x_r.numel()),
        {**entry("sqp_fused_tick", "sqp_fused.cu",
                 f"{jax_ops}/sqp_fused.py:45", tk["launches"], tk["err"],
                 tk["ms"], tk["plain_ms"], tk["flops"], tk["n_bytes"]),
         "launches_per_tick": tk["launches_per_tick"]},
        entry("qp_ip_gate", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **gate["b1"]),
        entry("sqp_fused_gate", "sqp_fused.cu", f"{jax_ops}/sqp_fused.py:45",
              **gate["b2"]),
        entry("sqp_fused_rollout", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **ro),
        entry("qp_ip_goal_gate", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **goal_gate["b1"]),
        entry("sqp_fused_goal_gate", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **goal_gate["b2"]),
        entry("sqp_fused_goal_rollout", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **goal_ro),
        entry("sqp_fused_multirobot_rollout", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **mr_ro),
        entry("sqp_fused_tmpc_rollout", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **tmpc_ro),
        entry("sqp_fused_ccmpc", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **cc["b2"]),
        entry("qp_ip_ccmpc", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **cc["b1"]),
        entry("sqp_fused_ccmpc_config3", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **cc3["b2"]),
        entry("sqp_fused_ccmpc_rollout", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **cc_ro),
        entry("sqp_fused_shmpc", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **sh["b2"]),
        entry("qp_ip_6_2", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **sh["b1"]),
        entry("sqp_fused_shmpc_tick", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **sh_tick["b2"]),
        entry("qp_ip_lanes_shmpc_tick", "qp_ip.cu",
              f"{jax_ops}/qp_pallas.py:794", **sh_tick["b1"]),
        entry("sqp_linearize_mirror", "sqp_linearize_mirror.cu",
              f"{jax_ops}/sqp_fused.py:45", mt["mirror_launches"],
              **mt["lin"]),
        entry("sqp_linearize_mirror_shmpc", "sqp_linearize_mirror.cu",
              f"{jax_ops}/sqp_fused.py:45",
              sh_tick["b1"]["mirror_launches"], **sh_tick["lin"]),
        {**entry("qp_ip_lanes_tick", "qp_ip.cu",
                 f"{jax_ops}/qp_pallas.py:794", **mt["b1"]),
         "launches_per_tick": mt["launches_per_tick"]},
        entry("sqp_fused_multirobot_tick", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **mr_tick),
        entry("sqp_fused_dynvref", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **vref),
        entry("sqp_fused_lmpcc", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **lmpcc),
        entry("sqp_fused_bicycle", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **bicycles["bicycle"]["b2"]),
        entry("qp_ip_6_3", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **bicycles["bicycle"]["b1"]),
        entry("sqp_fused_bicycle_ca", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **bicycles["CA bicycle"]["b2"]),
        entry("qp_ip_6_3_ca", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **bicycles["CA bicycle"]["b1"]),
        entry("sqp_fused_ca", "sqp_fused.cu", f"{jax_ops}/sqp_fused.py:45",
              **ca),
        entry("sqp_fused_decomp", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **dec["decomp"]),
        entry("sqp_fused_road", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **dec["road"]),
        entry("sqp_fused_mesh", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **mesh_b2),
        entry("sqp_fused_bench_small", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **ep["small"]),
        entry("sqp_fused_resident_rollout", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", **ep["rollout"]),
        entry("sqp_single", "sqp_single.cu", f"{jax_ops}/sqp.py:437",
              **s1_golden),
        {**entry("sqp_single_basic_tick", "sqp_single.cu",
                 f"{jax_ops}/sqp.py:437", **s1_basic),
         "launches_per_tick": s1_basic["launches"] / BASIC_TICKS},
        entry("sqp_single_xla_fleet", "sqp_single.cu",
              f"{jax_ops}/sqp.py:437", **s1_xla),
        entry("sqp_single_demo", "sqp_single.cu", f"{jax_ops}/sqp.py:437",
              **ep["demo"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
