#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Builds the three kernel libraries from the checkout, in parallel, and prints
each ptxas report: the interior-point QP kernel (csrc/qp_ip.cu, with its
cold, duals/warm and field-layout entries), the fused whole-SQP kernel
(csrc/sqp_fused.cu, with its linearize entry) and the FP32 roof kernel
(csrc/fma_roof.cu). B1 and B2 run one warp per problem with its state in
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
ticks. Then the single-instance solve (plain PyTorch, no kernel of the
port) and BASELINE config 2 (contouring with ellipsoidal obstacles), each
run with the launch counts set to 0 just before it: the contouring_2obs
golden through make_sqp_solver at f64 (atol 1e-6, rtol 1e-8; ms and device
ops per solve); BASELINE's f32 gate (max |U32 - U64| <= 1e-3 against
tests/golden/validate_contouring_U64.npy) through B1 and through B2, with
B1 at the gate's QPs against its plain version; the configuration_basic
planner tick at default_settings (N=30, f64; Planner -> Solver.solve) on
the card, its first tick against the same solve on the CPU; and the
contouring evaluator of tools/bench_rollout.py (4096 episodes, 60 ticks,
f32, one B2 launch per tick, nothing read back between ticks, f64 kernel
against plain on a short rollout, B2 on its first tick against plain at
f64, every problem, and at f32). Then BASELINE config 1 (goal tracking on
SecondOrderUnicycleModel, nx=4, with 3 ellipsoids) and the other
evaluators, each run with the launch counts set to 0 just before it:
(e) its f32 gate against tests/golden/validate_goal_U64.npy through B1's
(4, 2) instance and through B2's goal model, B1 at the gate's QPs against
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
with B1 (6, 2) once per SQP iteration): success, no contact with the
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
each at N=8 (B2 or the single-instance solve), the LMPCC fleet (512
problems) through B2 against its plain version, and one
LocalPlannerInterface cycle. Then ROADMAP item 4d, each fleet and tick run
with the launch counts set to 0 before it: (l) configuration_bicycle and
its curvature-aware variant (N=30, nx=6, nu=3, m=22) as 512-problem fleets
through B2 (the bicycle models) and through B1's (6, 3) instance, each
against its plain version, their launch plans at T=31, nz=9, and the
bicycle_contouring golden through make_sqp_solver at f64; (m) the
curvature-aware unicycle: B2's in-kernel linearization (the progress
update, the CA contouring cost) against torch.func at f64 on curved and
exactly straight paths with no NaN (the CA bicycle's too), and its fleet
through B2 against plain; (n) the decomposition's C++ backend, the decomp
fleet (12 halfspace rows) through B2 against plain, 3 ticks of JAX's
corridor scene through LocalPlannerInterface.set_costmap /
compute_velocity_commands (JAX's assertions; the single-instance solve,
timed, not gated) and the road-width bicycle fleet through B2 against
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
Any failed phase raises, so the script exits non-zero and prints no result. The last line is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
each with its bound. Needs one CUDA device; without one it exits with code 2.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (  # noqa: E402
    BENCH_SCHEDULE, FUSED_F64_GATE, LIN_F64_ATOL, LIN_F64_RTOL, QP_F64_GATE,
    bench_config, bench_fleet, card_line, cuda_time_ms)

B_MAIN, N_MAIN, N_PATHS = 512, 20, 8
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


def spread(times):
    """min / max of a list of ms, for the log."""
    return f"min {min(times):.3f}, max {max(times):.3f}"


# ---------------------------------------------------------------------------
# The planner tick (bench.py::_e2e_tick): Planner -> TMPCOptimizer -> B2
# ---------------------------------------------------------------------------
#: 12 crossing pedestrians spaced along the 65 m path, each walking from
#: (x0, y0) to (x0, -y0).
TICK_PEDESTRIANS = [(5.0, 3.0), (9.0, -3.0), (13.0, 2.5), (20.0, 3.0),
                    (24.0, -3.0), (28.0, 2.5), (35.0, 3.0), (39.0, -3.0),
                    (43.0, 2.5), (50.0, 3.0), (54.0, -3.0), (58.0, 2.5)]
TICKS, TICK_SKIP, TICK_DT = 124, 4, 0.2
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


class SimClock:
    """The simulated clock of a tick run, advanced by dt per tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def build_tick_planner(dev):
    """The tick of bench.py::_e2e_tick on ``dev`` at f32: N=20, 3 obstacles,
    4 guided planners and 1 unguided, the bench operating point; prewarmed
    (the kernels and the PRM library built)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        build_planner, configuration_tmpc_consistency_cost, prewarm_planner)
    from oscar_mpc_planner_mr_modification_tpu_torch.modules import (
        GuidanceConstraintModule)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    settings = default_settings(N=N_MAIN, max_obstacles=3)
    model, modules = configuration_tmpc_consistency_cost(settings)
    clock = SimClock()
    planner = build_planner(model, modules, settings, dtype=torch.float32,
                            sqp_config=bench_config(), clock=clock,
                            device=dev)
    optimizer = next(m for m in planner.modules
                     if isinstance(m, GuidanceConstraintModule))._optimizer
    t = time.perf_counter()
    prewarm_planner(planner, model, settings)
    log(f"tick planner built and prewarmed in {time.perf_counter() - t:.2f} s")
    return planner, model, settings, optimizer, clock


def run_ticks(tick, pipelined, capture_at=None, profile_last=False,
              bench_timing=False):
    """TICKS ticks of the scenario from its start (the first TICK_SKIP not
    timed), serial (``solve_mpc``) or pipelined (``solve_mpc_start``, the
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

    from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E501
        define_robot_area, ensure_obstacle_size)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim import (
        Pedestrian, PedestrianSimulator)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim.roadmap import (
        straight_path)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
    from oscar_mpc_planner_mr_modification_tpu_torch.types import RealTimeData

    planner, model, settings, optimizer, clock = tick
    N = planner.solver.N
    planner.reset()
    clock.t = 0.0
    state = State(model)
    state.set("v", 0.8)
    peds = [Pedestrian(np.array([x0, y0]), np.array([x0, -y0]))
            for x0, y0 in TICK_PEDESTRIANS]
    psim = PedestrianSimulator(peds, dt=TICK_DT)
    ref = straight_path(length=65.0)
    r_robot = float(settings["robot_radius"])
    iv = model.state_index("v")

    def build_data(st):
        d = RealTimeData()
        d.robot_area = define_robot_area(0.65, 0.65, 1)
        d.reference_path = ref
        d.dynamic_obstacles = ensure_obstacle_size(
            psim.get_obstacles(N), st, settings["max_obstacles"], N, TICK_DT)
        return d

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
        a = planner.get_solution(0, "a") if out.success else -3.0
        w = planner.get_solution(0, "w") if out.success else 0.0
        return out, nxt, a, w, world

    def advance(a, w, world):
        x = model.discrete_dynamics(
            torch.as_tensor(state.as_array()),
            torch.tensor([a, w], dtype=torch.float64), TICK_DT).numpy()
        x[iv] = max(x[iv], 0.0)
        state.set_array(x)
        clock.t += TICK_DT
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
        for i in range(TICKS):
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

    tick = build_tick_planner(dev)
    planner, _, _, optimizer, _ = tick
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
        rec = run_ticks(tick, pipelined, capture_at=None if pipelined else 60,
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
# The single-instance solve (plain PyTorch) and BASELINE config 2
# ---------------------------------------------------------------------------
#: The golden's config (tests/test_golden.py) and BASELINE's f32 operating
#: point (examples/validate_tpu.py).
GOLDEN_CFG = dict(n_sqp=30, n_qp_iter=20, mu_min=1e-10)
GATE_CFG = dict(n_sqp=25, n_qp_iter=15, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
                regularization="gershgorin")
GATE_B = 4
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


def device_trace(fn, pad=0):
    """The device ops (kernels, copies, fills) of one call of fn in start
    order, by a torch.profiler trace of the device alone (a trace of the
    host's ops too costs seconds for a few thousand launches). With ``pad``,
    ``pad`` one-element additions run before and after fn inside the trace:
    the card's traces of long rollouts have dropped their first or last few
    device ops, and the padding is what such a loss then takes."""
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
        ops = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if ops:
            return ops
        log("a trace of the device alone held no device op; tracing the "
            "host's ops too")
    return ops


def solve_launches(make, args, config):
    """Device ops of one solve at ``config``, from three profiled short
    solves: the plain solve has no data-dependent branch, so its ops are
    base + per_sqp * (SQP iterations) + per_ip * (IP iterations). ``make``
    builds the solve of a config; it is called with ``args``."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _phases_of)

    def ops(n_sqp, n_qp):
        fn = make(config._replace(n_sqp=n_sqp, n_qp_iter=n_qp,
                                  qp_iter_schedule=()))
        return len(device_trace(lambda: fn(*args)))

    l11, l12, l21 = ops(1, 1), ops(1, 2), ops(2, 1)
    check(0 < l11 < l12 and l11 < l21, f"profiled short solves traced "
          f"{l11}, {l12}, {l21} device ops")
    per_ip = l12 - l11
    per_sqp = l21 - l11 - per_ip
    base = l11 - per_sqp - per_ip
    phases = _phases_of(config)
    return dict(total=base + per_sqp * sum(n for n, _ in phases)
                + per_ip * sum(n * q for n, q in phases),
                base=base, per_sqp=per_sqp, per_ip=per_ip)


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


def basic_ocp(N, n_obstacles):
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    settings = default_settings(N=N, max_obstacles=n_obstacles)
    return build_ocp(*configuration_basic(settings), settings)


def golden_single_phase(dev, card, reset_counts, counts, none):
    """(a) The contouring_2obs golden through make_sqp_solver on the card at
    f64 (plain PyTorch, no kernel): Z within atol 1e-6, cost within rtol
    1e-8, success; its ms and device ops per solve; which of its parts wait
    for the device. Returns the solution Z (numpy)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp as qp_ip
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, make_sqp_solver)

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
    check(got == none, f"single-instance golden solve launched no kernel of "
          f"the port ({got})")
    check(res.z.device.type == "cuda", f"solution on {res.z.device}")
    zerr = float(np.abs(res.z.cpu().numpy() - gold["Z"]).max())
    cost = float(res.cost)
    log(f"single-instance golden (f64, cuda): max|Z - Z_gold| {zerr:.3e}, "
        f"cost {cost:.12f} vs {float(gold['cost']):.12f}, eq_res "
        f"{float(res.eq_res):.3e}, qp_comp {float(res.qp_comp):.3e}")
    check(bool(res.success), "single-instance golden solve succeeded")
    check(zerr <= 1e-6, "single-instance golden Z within atol 1e-6")
    check(abs(cost - float(gold["cost"])) <= 1e-8 * abs(float(gold["cost"])),
          "single-instance golden cost within rtol 1e-8")
    ops = solve_launches(lambda c: make_sqp_solver(
        ocp, c, dtype=torch.float64, device=dev), args, cfg)
    # Which parts wait for the device ("mirror" regularization's eigh reads
    # its convergence flags back to the host).
    mach = solve.machinery
    P = torch.as_tensor(gold["P"], device=dev)[None]
    P = torch.cat([P, P[:, -1:]], dim=1)
    Z = torch.as_tensor(gold["Z"], device=dev)[None]
    x0 = torch.as_tensor(gold["x0"], device=dev)[None]
    qp = mach.build_qp(Z, P, x0)
    qpd = qp_ip.QPData(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                       torch.as_tensor(mach.stage_mask, device=dev), qp.r0)
    sync()
    waits = {"solve_qp (20 IP iterations)": host_syncs(
                 lambda: qp_ip.solve_qp(qpd, nu=ocp.nu, n_iters=20)),
             "build_qp, mirror": host_syncs(lambda: mach.build_qp(Z, P, x0)),
             "merit_of": host_syncs(lambda: mach.merit_of(Z, P, x0))}
    g_mach = make_sqp_solver(ocp, cfg._replace(regularization="gershgorin"),
                             dtype=torch.float64, device=dev).machinery
    waits["build_qp, gershgorin"] = host_syncs(lambda: g_mach.build_qp(Z, P,
                                                                      x0))
    log(f"calls that wait for the device (sync debug mode), per call: "
        f"{ {k: len(v) for k, v in waits.items()} }, at {waits}")
    log(f"[{card}] single-instance solve (N=15, {cfg.n_sqp} x {cfg.n_qp_iter},"
        f" f64, plain PyTorch): {ms:.1f} ms per solve; "
        f"{ops['total']} device ops per solve ({ops['per_ip']} per IP "
        f"iteration, {ops['per_sqp']} per SQP iteration besides, "
        f"{ops['base']} once; from three profiled short solves)")
    return res.z.cpu().numpy()


def goal_ocp():
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.rollout import (
        _goal_ellipsoid_ocp)

    return _goal_ellipsoid_ocp(3, 20)[0]


#: BASELINE's f32 gate by flavour: the golden (inputs and CPU-f64 solve),
#: the committed CPU-f64 controls, the OCP and its operation counts (the
#: roofline constants of its IP iteration, linearization and merit).
GATE_FLAVOURS = {
    "contouring": ("contouring_2obs.npz", "validate_contouring_U64.npy",
                   lambda: basic_ocp(15, 2), "GATE"),
    "goal": ("goal_tracking_3obs.npz", "validate_goal_U64.npy", goal_ocp,
             "GOAL"),
}


def baseline_gate_phase(dev, card, reset_counts, counts, none, flavour,
                        ref_z=None):
    """BASELINE's f32 gate of one flavour (examples/validate_tpu.py;
    ``GATE_FLAVOURS``): the golden's problem tiled to B=4 at the f32
    operating point through B1 (``"pallas"``) and through B2 (``"fused"``),
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

    golden, u64, make_ocp, consts = GATE_FLAVOURS[flavour]
    gold = np.load(os.path.join(ROOT, "tests", "golden", golden))
    U64 = np.load(os.path.join(ROOT, "tests", "golden", u64))
    ocp = make_ocp()
    nu = ocp.nu
    cfg = SQPConfig(**GATE_CFG)
    tiled = (np.tile(gold["P"][None], (GATE_B, 1, 1)),
             np.tile(gold["x0"][None], (GATE_B, 1)),
             np.tile(gold["z_init"][None], (GATE_B, 1, 1)))
    want = {"pallas": {**none, "qp_ip": cfg.n_sqp},
            "fused": {**none, "sqp_fused": 1}}
    launches, fleets = {}, {}
    for backend in ("pallas", "fused"):
        fleet = fleets[backend] = make_fleet_sqp_solver(
            ocp, cfg, dtype=torch.float32, device=dev, backend=backend)
        reset_counts()
        out = fleet(*tiled)
        sync()
        got = counts()
        launches[backend] = got
        check(got == want[backend], f"{flavour} f32 gate through {backend!r}: "
              f"launches {got} (want {want[backend]})")
        U32 = out.z.cpu().numpy()[:, :-1, :nu]
        err = float(np.abs(U32 - U64[None]).max())
        ref = "" if ref_z is None else (
            f"; vs the port's f64 make_sqp_solver on the card (the golden "
            f"phase's solve) {np.abs(U32 - ref_z[:-1, :nu]).max():.3e}; "
            f"golden vs that solve {np.abs(U64 - ref_z[:-1, :nu]).max():.3e}")
        log(f"[{card}] BASELINE f32 gate, {flavour}+ellipsoid (nx={ocp.nx}), "
            f"{backend!r}: max|U32 - U64| {err:.3e} over {GATE_B} problems "
            f"(gate 1e-3), success {out.success.tolist()}{ref}")
        check(err <= 1e-3, f"BASELINE f32 gate, {flavour}, through "
              f"{backend!r}: max|U32 - U64| {err:.3e} <= 1e-3")
        check(bool(out.success.all()), f"{flavour} f32 gate through "
              f"{backend!r} succeeded")

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
                           reps=5)
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
    fs = fleets["fused"]
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
    the card, no kernel of the port, and the first tick equals the same
    solve on the CPU within atol 1e-6."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        build_planner, configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        fetch_result_single, make_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E501
        define_robot_area, ensure_obstacle_size)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim import (
        Pedestrian, PedestrianSimulator)
    from oscar_mpc_planner_mr_modification_tpu_torch.sim.roadmap import (
        straight_path)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
    from oscar_mpc_planner_mr_modification_tpu_torch.types import RealTimeData
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
    iv = model.state_index("v")
    ref = straight_path(length=65.0)
    state = State(model)
    state.set("v", 0.8)
    peds = [Pedestrian(np.array([x0, y0]), np.array([x0, -y0]))
            for x0, y0 in TICK_PEDESTRIANS]
    psim = PedestrianSimulator(peds, dt=TICK_DT)

    def tick(first):
        psim.step([state.get_position()])
        data = RealTimeData()
        data.robot_area = define_robot_area(0.65, 0.65, 1)
        data.reference_path = ref
        data.dynamic_obstacles = ensure_obstacle_size(
            psim.get_obstacles(N), state, settings["max_obstacles"], N,
            TICK_DT)
        if first:
            planner.on_data_received(data, "reference_path")
        out = planner.solve_mpc(state, data)
        a = planner.get_solution(0, "a") if out.success else -3.0
        w = planner.get_solution(0, "w") if out.success else 0.0
        x = model.discrete_dynamics(torch.as_tensor(state.as_array()),
                                    torch.tensor([a, w], dtype=torch.float64),
                                    TICK_DT).numpy()
        x[iv] = max(x[iv], 0.0)
        state.set_array(x)
        return out, min(np.linalg.norm(state.get_position() - p.position)
                        - r_robot - p.radius for p in peds)

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
    check(got == none, f"basic planner ticks launched no kernel of the port "
          f"({got})")
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
    # device ops per tick: Solver.solve's (uploads, solve, one readback),
    # extrapolated from short solves; the modules' work is on the host
    ops = solve_launches(lambda c: (lambda *a: fetch_result_single(
        make_sqp_solver(solver.ocp, c, dtype=torch.float64, device=dev)(
            *a))), first_in, solver.config)
    log(f"[{card}] basic planner tick (configuration_basic, N={N}, "
        f"{solver.config.n_sqp} x {solver.config.n_qp_iter}, f64, "
        f"{BASIC_TICKS} ticks, ladder entry {full}): tick "
        f"{np.median(tick_ms):.1f} ms median ({[round(t, 1) for t in tick_ms]}"
        f"), solve {np.median(solve_ms):.1f} ms median; "
        f"{ops['total']} device ops per tick's solve ({ops['per_ip']} per IP "
        f"iteration, {ops['per_sqp']} per SQP iteration besides); smallest "
        f"clearance {clearance:.4f} m; progress "
        f"{state.get('x'):.3f} m")
    return dict(tick_ms=float(np.median(tick_ms)),
                solve_ms=float(np.median(solve_ms)),
                ops=ops["total"])


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
    # outlasts what the card's traces have dropped at their end: up to ~70
    # ops of a T-MPC rollout's ~17400 on an H100 80GB HBM3 (700 W).
    scenes = ev.scenes(B, 3)
    names = [e.name for e in device_trace(
        lambda: read_metrics(rollout(*scenes)), pad=256)]
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
    rk, rp = fs(P, x, Z), fs.reference(P, x, Z)
    sync()
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
    p_ms, _ = cuda_time_ms(lambda: fs.reference(P, x, Z), reps=2, warmup=0)
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
SH_TICKS, SH_MIRROR_TICKS = 60, 3
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
                           reps=3)
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
    (f64 within FUSED_F64_GATE, same success) and timed. Then SH_MIRROR_TICKS
    ticks under "mirror": B1 at (6, 2) once per SQP iteration and nothing
    else, success, and B1 at that tick's QPs against its plain version.
    Returns the kernel entry numbers of B2 and B1 in the tick."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _make_machinery, _phases_of, make_fleet_sqp_solver)

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

    # "mirror": the per-iteration path, B1 at (6, 2) once per SQP iteration
    planner, model, settings, opt = build_sh_planner(dev, "mirror")
    check(opt.fleet_backend == "pallas", f"SH-MPC backend under 'mirror' "
          f"{opt.fleet_backend!r} == 'pallas'")
    reset_counts()
    recs, captured, state = run_sh_ticks(planner, model, settings, opt,
                                         SH_MIRROR_TICKS, capture_at=1)
    got = counts()
    n_sqp = planner.solver.config.n_sqp
    check(got == {**none, "qp_ip": n_sqp * SH_MIRROR_TICKS}, f"SH-MPC "
          f"'mirror' ticks: launches {got} (want B1 (6, 2) once per SQP "
          f"iteration, {n_sqp * SH_MIRROR_TICKS}, and nothing else)")
    summary("'mirror', B1 (6, 2)", recs, state)
    check(all(r["success"] for r in recs) and min(
        r["clearance"] for r in recs) > 0.0, "SH-MPC 'mirror' ticks succeed "
          "without contact")
    params, xinit, warm = captured
    ocp, cfg = planner.solver.ocp, planner.solver.config
    for dtype in (torch.float64, torch.float32):
        mach = _make_machinery(ocp, cfg, dtype, dev)
        Pd = torch.as_tensor(params, dtype=dtype, device=dev)
        Zd = torch.as_tensor(warm, dtype=dtype, device=dev)
        xd = torch.as_tensor(xinit, dtype=dtype, device=dev)[None].expand(
            P, -1)
        qp = mach.build_qp(Zd, torch.cat([Pd, Pd[:, -1:]], dim=1), xd)
        kw = dict(nu=ocp.nu, n_iters=cfg.n_qp_iter, mu_min=1e-6, w_max=1e6,
                  row_meta=mach.row_meta)
        qa = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask,
              qp.r0)
        dz_k = qp_cuda.solve_qp_batched(*qa, **kw)
        dz_p = qp_cuda.ip_solve_reference(*qa, **kw)
        sync()
        b1_err = (dz_k - dz_p).abs().max().item()
        scale = 1.0 + dz_p.abs().max().item()
        log(f"{str(dtype)[6:]} B1 (6, 2) at the SH-MPC tick's QPs ({P} "
            f"problems, m={qp.D.shape[2]}, {cfg.n_qp_iter} iterations): "
            f"max|ddz| {b1_err:.3e}, max|dz| {scale - 1:.3e}")
        if dtype == torch.float64:
            check(b1_err <= QP_F64_GATE * scale, "f64 B1 (6, 2) = plain at "
                  f"the SH-MPC tick's QPs: max|ddz| <= {QP_F64_GATE:g} "
                  "(1 + max|dz|)")
    k1_ms, k1_all = cuda_time_ms(lambda: qp_cuda.solve_qp_batched(*qa, **kw),
                                 reps=20)
    p1_ms, _ = cuda_time_ms(lambda: qp_cuda.ip_solve_reference(*qa, **kw),
                            reps=3)
    log(f"[{card}] B1 (6, 2) at the SH-MPC tick ({P} problems, f32, "
        f"{cfg.n_qp_iter} iterations): {k1_ms:.3f} ms per launch (median of "
        f"20; {spread(k1_all)}), plain {p1_ms:.1f} ms")
    mh = sum(meta[0] == "h" for meta in mach.row_meta)
    b1 = dict(launches=got["qp_ip"], err=b1_err, ms=k1_ms, plain_ms=p1_ms,
              flops=roofline.ip_flops(P, cfg.n_qp_iter,
                                      ip_iter=roofline.SHMPC_IP_ITER_FLOPS),
              n_bytes=roofline.qp_bytes(qp.g.shape[1], ocp.nx, ocp.nu,
                                        qp.D.shape[2], mh, P, 4))
    return dict(b2=b2, b1=b1)


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
    xinit (nx,), warm (P, N + 1, nz), numpy) against its plain version: f64
    on every problem within FUSED_F64_GATE with the same success, f32 by the
    median; then the f32 kernel (median of 20) and its plain version
    (median of 3) timed by CUDA events.
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
                           reps=3, warmup=0)
    log(f"[{card}] B2 at {name} (P={P}, T={params.shape[1] + 1}, f32, CUDA "
        f"events): {k_ms:.3f} ms (median of 20; {spread(k_all)}), plain "
        f"fused_fleet_reference {p_ms:.3f} ms (median of 3)")
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
    scenario module) the single-instance solve, no kernel; at least 2 of 3 ticks solved and x >
    0.1. Then the LMPCC fleet (tools/bench_matrix.py::build_lmpcc, 512
    problems) through B2 against its plain version, and one
    ``LocalPlannerInterface.compute_velocity_commands`` cycle (basic, N=8)
    on the card. Returns the LMPCC fleet's kernel entry numbers."""
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
        path = "B2" if b2 else "the single-instance solve"
        want = {**none, "sqp_fused": SWEEP_TICKS} if b2 else none
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
    check(ok and v > 0.3 and abs(w) < 1.0 and got == none
          and not lp.is_goal_reached(),
          f"LocalPlannerInterface cycle on the card: success, v > 0.3, |w| < "
          f"1, no kernel launch (the single-instance solve), goal not "
          f"reached ({got})")
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
    the card (plain PyTorch, no kernel; atol 1e-6, cost rtol 1e-8, as
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
        f"solve (host-bound plain PyTorch), launches {got}")
    check(got == none and res.z.device.type == "cuda",
          f"bicycle golden on the card, no kernel of the port ({got})")
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
        f"{CORRIDOR_N}, f64, the single-instance solve): ms per tick "
        f"{[round(t, 1) for t in times]}, last plan x {traj[-1, ix]:.3f} m, "
        f"max |y| {np.abs(traj[:, iy]).max():.4f}, launches {got}")
    check(got == none, f"corridor ticks: the single-instance solve, no "
          f"kernel of the port ({got})")
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
                plain_ms, _ = cuda_time_ms(lambda: step(*args), reps=2,
                                           warmup=0)
            agree = (out[3] == out_p[3]).float().mean().item()
            log(f"[{card}] (o1) mesh step through B2's plain twin: "
                f"{plain_ms:.3f} ms (median of 2), any_ok agreement "
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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"ok: {msg}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline, sqp_fused)
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

    # ---- 2. build (one nvcc per kernel source, all started together) ------
    t = time.perf_counter()
    infos = qp_cuda.build_all()
    qp_cuda._library()
    sqp_fused._library()
    roofline._library()
    log(f"built {len(infos)} kernel libraries in {time.perf_counter() - t:.2f} s")
    for name, info in infos.items():
        log(f"{name}: {os.path.relpath(info.path, ROOT)} (nvcc {info.seconds:.2f} s)")
        for line in info.log.splitlines():
            if "entry function" in line or "Function properties for" in line:
                log(f"ptxas {name}: {line.strip()}")
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log_launch_plans(dev)

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

    # ---- 9. times ----------------------------------------------------------
    step_ms, step_all = cuda_time_ms(lambda: step(*args), reps=10)
    b1_step_ms, _ = cuda_time_ms(lambda: step_b1(*args), reps=5, warmup=1)
    with plain_fused_solver(step.fleet_solve):
        plain_fused_ms, _ = cuda_time_ms(lambda: step(*args), reps=3, warmup=0)
    with plain_qp_solver():
        plain_step_ms, _ = cuda_time_ms(lambda: step_b1(*args), reps=3,
                                        warmup=0)
    log(f"[{card}] fleet step (B={B_MAIN} x {P} planners, N={N_MAIN}, f32), "
        f"median of 10 / 5 / 3 / 3: fused kernel path {step_ms:.3f} ms = "
        f"{B_MAIN / step_ms * 1e3:.1f} plans/s; per-iteration (QP kernel) "
        f"path {b1_step_ms:.3f} ms = {B_MAIN / b1_step_ms * 1e3:.1f} plans/s; "
        f"plain fused path {plain_fused_ms:.3f} ms = "
        f"{B_MAIN / plain_fused_ms * 1e3:.1f} plans/s; plain per-iteration "
        f"path {plain_step_ms:.3f} ms = {B_MAIN / plain_step_ms * 1e3:.1f} "
        f"plans/s; fused step {spread(step_all)}")
    flat = flat_fleet(args)
    f_ms, f_all = cuda_time_ms(lambda: step.fleet_solve(*flat), reps=10)
    fp_ms, _ = cuda_time_ms(lambda: step.fleet_solve.reference(*flat), reps=3,
                            warmup=0)
    log(f"[{card}] fused solve at the bench shape ({B_MAIN * P} problems, "
        f"T={N_MAIN + 1}, schedule {BENCH_SCHEDULE}, f32): kernel {f_ms:.3f} "
        f"ms per launch (median of 10; {spread(f_all)}), plain "
        f"fused_fleet_reference {fp_ms:.3f} ms (median of 3)")
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
        lambda: qp_cuda.ip_solve_reference(*qp_args(qpb, machb), **kw), reps=5)
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
        *qp_args(qp_1, mach_d), duals_out=True, **kw_w), reps=5)
    log(f"[{card}] duals/warm IP solve per launch at the bench shape (warm, 8 "
        f"iterations, f32): kernel {dk_ms:.3f} ms (median of 20; "
        f"{spread(dk_all)}), plain {dp_ms:.3f} ms")

    # ---- 11. path (a): the dual-warm per-iteration fleet step -------------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_roofline, bench_warm)

    def reset_counts():
        qp_cuda.launches = qp_cuda.duals_launches = qp_cuda.warm_launches = 0
        qp_cuda.lanes_launches = sqp_fused.launches = 0
        sqp_fused.linearize_launches = sqp_fused.merit_launches = 0
        roofline.launches = 0

    def counts():
        return dict(qp_ip=qp_cuda.launches, duals=qp_cuda.duals_launches,
                    warm=qp_cuda.warm_launches, lanes=qp_cuda.lanes_launches,
                    sqp_fused=sqp_fused.launches,
                    linearize=sqp_fused.linearize_launches,
                    merit=sqp_fused.merit_launches)

    none = dict.fromkeys(counts(), 0)
    n_sqp_w = bench_warm.BASE.n_sqp
    warm_ref, warm_ms = None, {}
    for name, wcfg in bench_warm.VARIANTS:
        wstep = make_batched_tmpc_step(ocp, wcfg, dtype=torch.float32,
                                       device=dev, backend="pallas")
        reset_counts()
        wout = wstep(*args)
        torch.cuda.synchronize()
        got = counts()
        want = ({**none, "duals": n_sqp_w, "warm": n_sqp_w - 1}
                if wcfg.n_qp_iter_warm else {**none, "qp_ip": n_sqp_w})
        check(got == want, f"{name} step (n_sqp={n_sqp_w}, n_qp_iter="
              f"{wcfg.n_qp_iter}, n_qp_iter_warm={wcfg.n_qp_iter_warm}) "
              f"launches {got} (want {want})")
        if name == "warm8":
            warm_launches = got["duals"]
        summ = bench_warm.summary(wout)
        warm_ms[name], _ = cuda_time_ms(lambda: wstep(*args), reps=2,
                                        warmup=0)
        log(f"[{card}] {name} step: {warm_ms[name]:.3f} ms (median of 2) = "
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
        lambda: qp_cuda.fields_reference(fields, mask_l, **kw_l), reps=5)
    log(f"[{card}] lane QP entry per launch at the bench shape (8 iterations, "
        f"f32): kernel {lk_ms:.3f} ms (median of 20; {spread(lk_all)}), "
        f"plain {lp_ms:.3f} ms")

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
    fpl_ms, _ = cuda_time_ms(lambda: roofline.fma_roof_reference(x_r), reps=5)
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

    # ---- 14. the planner tick: Planner -> TMPCOptimizer -> one B2 --------
    tk = tick_phase(dev, card, reset_counts, counts, none)

    # ---- 15-18. the single-instance solve and BASELINE config 2 ----------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_rollout import (  # noqa: E501
        evaluators)

    evs = evaluators(N=ROLLOUT_N, n_ticks=ROLLOUT_TICKS)
    golden_z = golden_single_phase(dev, card, reset_counts, counts, none)
    gate = baseline_gate_phase(dev, card, reset_counts, counts, none,
                               "contouring", golden_z)
    basic_tick_phase(dev, card, reset_counts, counts, none)
    ro = evaluator_phase(dev, card, reset_counts, counts, none,
                         evs["contouring"], short_ticks=5,
                         f32_share=F32_ROLLOUT_SHARE)

    # ---- 19-22. BASELINE config 1 and the other evaluators ---------------
    goal_gate = baseline_gate_phase(dev, card, reset_counts, counts, none,
                                    "goal")
    goal_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                              evs["goal"])
    mr_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                            evs["multirobot"],
                            f64_gate=COUPLED_F64_ROLLOUT_GATE)
    triggered_phase(dev, card, reset_counts, counts, none, evs["multirobot"])
    tmpc_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                              evs["tmpc"], f64_gate=COUPLED_F64_ROLLOUT_GATE)

    # ---- 23-27. BASELINE configs 3 (CC-MPC) and 5 (SH-MPC) -------------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    cases = matrix_phase(dev, card, reset_counts, counts, none)
    cc = fleet_flavour_phase(dev, card, reset_counts, counts, none, "CC-MPC",
                             cases["ccmpc"][0], cases["ccmpc"][1:], "CCMPC")
    ocp6, *arrays6 = bench_matrix.build_ccmpc(
        N_MAIN, CONFIG3_B, np.random.default_rng(0), CONFIG3_OBS)
    cc3 = fleet_flavour_phase(dev, card, reset_counts, counts, none,
                              "CC-MPC at config 3's size", ocp6, arrays6,
                              "CCMPC6", b1=False)
    cc_ro = evaluator_phase(dev, card, reset_counts, counts, none,
                            evs["ccmpc"])
    ccmpc_margin_phase(dev, card, evs)
    sh = fleet_flavour_phase(dev, card, reset_counts, counts, none, "SH-MPC",
                             cases["shmpc"][0], cases["shmpc"][1:], "SHMPC")
    sh_tick = shmpc_tick_phase(dev, card, reset_counts, counts, none)

    # ---- 28-30. the multi-robot driver, the dynamic velocity reference,
    # the configuration sweep ---------------------------------------------
    mr_tick = multirobot_phase(dev, card, reset_counts, counts, none)
    vref = dynvref_phase(dev, card, reset_counts, counts, none)
    lmpcc = sweep_phase(dev, card, reset_counts, counts, none)

    # ---- 31-33. the bicycles, the curvature-aware unicycle, decomp and
    # road width -----------------------------------------------------------
    bicycles = bicycle_phase(dev, card, reset_counts, counts, none)
    ca = ca_phase(dev, card, reset_counts, counts, none)
    dec = decomp_phase(dev, card, reset_counts, counts, none)

    # ---- 34-35. the sharded fleet step and the host layers ---------------
    mesh_b2 = mesh_phase(dev, card, reset_counts, counts, none)
    host_layers_phase(tk["scene"], mr_tick["metrics_log"])

    # ---- the kernels, each with its bound ---------------------------------
    def entry(name, source, replaces, launches, err, ms, plain_ms, flops,
              n_bytes, **_):
        bound, by = roofline.bound_ms(flops, n_bytes)
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
        entry("qp_ip_6_2_tick", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              **sh_tick["b1"]),
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
