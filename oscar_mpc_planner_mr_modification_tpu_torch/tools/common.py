"""What the tools, the examples and ``chip_smoke.py`` share: the card's
identity, CUDA-event timing, the bench fleet of ``bench.py`` (512 plans x 9
planners, N=20, f32) and its operating point, the single-robot tick scene of
``bench.py::_e2e_tick`` (:func:`tick_scene`), and the two problems of
BASELINE's f32 gate (:func:`gate_inputs`)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

#: The repository's root (the goldens live under ``tests/golden``).
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BENCH_SCHEDULE = ((1, 3), (1, 5), (2, 8))
BENCH_BATCH, BENCH_N, BENCH_PATHS = 512, 20, 8

#: The f64 gates that hold a kernel entry to its plain version
#: (``chip_smoke.py``, ``tools/kernel_check.py``): the QP kernel's z (and
#: lam) within ``QP_F64_GATE * (1 + max|ref|)``; the in-kernel linearization
#: within ``LIN_F64_RTOL`` / ``LIN_F64_ATOL`` on every field; the fused
#: kernel's iterate within ``FUSED_F64_GATE * (1 + max|ref|)`` per problem,
#: with the same success mask.
QP_F64_GATE = 1e-8
LIN_F64_RTOL, LIN_F64_ATOL = 1e-9, 1e-10
FUSED_F64_GATE = 1e-6


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def require_card(tool: str):
    """Exit with code 2 unless a CUDA device is present."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        sys.exit(2)


def sync(device):
    """Wait for ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_time_ms(fn, reps: int, warmup: int = 2, inner: int = 1):
    """``(median, all)`` ms per call of ``fn`` by CUDA events, each sample
    over ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times)), times


def ptxas_entries(build_log) -> dict:
    """``{kernel entry: (registers, cumulative stack bytes)}`` from an nvcc
    build log with ptxas' report (``-Xptxas -v``), by mangled name."""
    import re

    out, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers.* (\d+) bytes cumulative stack",
                      line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), int(m.group(2)))
            entry = None
    return out


def same_bits(a, b) -> bool:
    """Whether two results (tensors, or tuples of them) hold the same bits,
    NaN where NaN."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            a, b = a.nan_to_num(7.0), b.nan_to_num(7.0)
        return a.shape == b.shape and bool(torch.equal(a, b))
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


def bench_fleet(batch=BENCH_BATCH, dtype=torch.float32, device="cuda",
                N=BENCH_N):
    """The bench OCP and its fleet (seed 0) as tensors on ``device``."""
    from ..benchmarks import build_tmpc_fleet, tmpc_bench_ocp
    from ..parallel.batch import to_torch_fleet

    ocp, settings = tmpc_bench_ocp(N=N, n_paths=BENCH_PATHS)
    arrays = build_tmpc_fleet(ocp, settings, batch, seed=0)
    return ocp, to_torch_fleet(*arrays, device=device, dtype=dtype)


def bench_config():
    """The bench's SQP operating point (schedule 1x3+1x5+2x8, Gershgorin,
    last iterate)."""
    from ..ops.sqp import SQPConfig

    return SQPConfig(n_sqp=sum(n for n, _ in BENCH_SCHEDULE),
                     n_qp_iter=BENCH_SCHEDULE[-1][1], mu_min=1e-6, w_max=1e6,
                     reg_eps=1e-4, regularization="gershgorin",
                     track_best=False, qp_iter_schedule=BENCH_SCHEDULE)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by name (B1's four entries, B2's
    three and its mirror linearize entry, B3, S1)."""
    from ..ops import qp_cuda, roofline, sqp_fused, sqp_single

    return dict(qp_ip=qp_cuda.launches, duals=qp_cuda.duals_launches,
                warm=qp_cuda.warm_launches, lanes=qp_cuda.lanes_launches,
                sqp_fused=sqp_fused.launches,
                linearize=sqp_fused.linearize_launches,
                linearize_mirror=sqp_fused.mirror_launches,
                merit=sqp_fused.merit_launches, fma_roof=roofline.launches,
                sqp_single=sqp_single.launches)


def launches_since(before: dict) -> dict:
    """The launches each wrapper made since ``before`` (a
    :func:`launch_counts`)."""
    return {k: v - before[k] for k, v in launch_counts().items()}


# ---------------------------------------------------------------------------
# The single-robot tick of bench.py::_e2e_tick
# ---------------------------------------------------------------------------
#: 12 crossing pedestrians spaced along the 65 m path, each walking from
#: (x0, y0) to (x0, -y0), so that every timed tick of a 124-tick run sees
#: active obstacles.
TICK_PEDESTRIANS = [(5.0, 3.0), (9.0, -3.0), (13.0, 2.5), (20.0, 3.0),
                    (24.0, -3.0), (28.0, 2.5), (35.0, 3.0), (39.0, -3.0),
                    (43.0, 2.5), (50.0, 3.0), (54.0, -3.0), (58.0, 2.5)]
TICK_DT, TICK_PATH_LENGTH, TICK_START_V = 0.2, 65.0, 0.8


class SimClock:
    """A simulated clock, advanced by the scene's dt per tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TickScene:
    """The world of one robot's tick run: the robot at the origin at 0.8 m/s
    on a 65 m straight path among ``TICK_PEDESTRIANS``, a simulated clock,
    and the planner that drives it. :meth:`reset` starts a run;
    :meth:`build_data` is one tick's ``RealTimeData`` (the pedestrians'
    predictions over the planner's horizon, padded to ``max_obstacles``);
    :meth:`advance` moves the robot by one RK4 step on the host
    (``multirobot/driver.py::integrate_on_host``) and the clock by dt."""

    def __init__(self, planner, model, settings, clock):
        from ..sim.roadmap import straight_path

        self.planner, self.model, self.settings = planner, model, settings
        self.clock = clock
        self.N = planner.solver.N
        self.ref_path = straight_path(length=TICK_PATH_LENGTH)
        self.reset()

    @property
    def optimizer(self):
        """The T-MPC optimizer of the planner's guidance module."""
        from ..modules import GuidanceConstraintModule

        return next(m for m in self.planner.modules
                    if isinstance(m, GuidanceConstraintModule))._optimizer

    def reset(self):
        """The planner reset, the clock at 0, the robot and the pedestrians
        at their starts; returns the robot's ``State``."""
        from ..sim import Pedestrian, PedestrianSimulator
        from ..solver import State

        self.planner.reset()
        if self.clock is not None:
            self.clock.t = 0.0
        self.state = State(self.model)
        self.state.set("v", TICK_START_V)
        self.peds = [Pedestrian(np.array([x0, y0]), np.array([x0, -y0]))
                     for x0, y0 in TICK_PEDESTRIANS]
        self.psim = PedestrianSimulator(self.peds, dt=TICK_DT)
        return self.state

    def build_data(self, st):
        from ..planner.data_preparation import (define_robot_area,
                                                ensure_obstacle_size)
        from ..types import RealTimeData

        d = RealTimeData()
        d.robot_area = define_robot_area(0.65, 0.65, 1)
        d.reference_path = self.ref_path
        d.dynamic_obstacles = ensure_obstacle_size(
            self.psim.get_obstacles(self.N), st,
            self.settings["max_obstacles"], self.N, TICK_DT)
        return d

    def command(self, out):
        """The first control of a tick's plan, or a brake where it failed."""
        if not out.success:
            return -3.0, 0.0
        return (self.planner.get_solution(0, "a"),
                self.planner.get_solution(0, "w"))

    def advance(self, a, w):
        """The robot one step on (its speed floored at 0), the clock by
        dt."""
        from ..multirobot.driver import integrate_on_host

        x = integrate_on_host(self.model, self.state.as_array(), [a, w],
                              TICK_DT)
        iv = self.model.state_index("v")
        x[iv] = max(x[iv], 0.0)
        self.state.set_array(x)
        if self.clock is not None:
            self.clock.t += TICK_DT


def tick_scene(device="cuda", dtype=torch.float32, N=BENCH_N, config=None,
               prewarm=True, from_settings=False) -> TickScene:
    """The tick of ``bench.py::_e2e_tick``: the planner on
    ``configuration_tmpc_consistency_cost`` (N, 3 obstacles, 4 guided and 1
    unguided planners) at ``config`` (the bench's operating point by
    default; with ``from_settings`` the settings' own, as a planner built
    with ``sqp_config=None`` has it: 10 SQP x 18 IP iterations under
    ``"mirror"``) on ``device``, in its :class:`TickScene`; with ``prewarm``
    the kernels and the PRM library are built before it returns."""
    from ..factory import (build_planner, configuration_tmpc_consistency_cost,
                           prewarm_planner)
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=3)
    model, modules = configuration_tmpc_consistency_cost(settings)
    clock = SimClock()
    planner = build_planner(
        model, modules, settings, dtype=dtype,
        sqp_config=None if from_settings else config or bench_config(),
        clock=clock, device=device)
    if prewarm:
        prewarm_planner(planner, model, settings)
    return TickScene(planner, model, settings, clock)


# ---------------------------------------------------------------------------
# BASELINE's f32 gate (the JAX package's examples/validate_tpu.py)
# ---------------------------------------------------------------------------
#: The gate's operating point, its fleet of copies of one problem, and its
#: limit on the control error against the committed CPU-f64 controls.
GATE_CFG = dict(n_sqp=25, n_qp_iter=15, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
                regularization="gershgorin")
GATE_B, GATE_TOL = 4, 1e-3


def basic_ocp(N, n_obstacles):
    """``configuration_basic`` (contouring with ellipsoids) at N."""
    from ..factory import configuration_basic
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=n_obstacles)
    return build_ocp(*configuration_basic(settings), settings)


def goal_ocp():
    """BASELINE config 1's goal OCP (3 ellipsoids, N=20)."""
    from ..parallel.rollout import _goal_ellipsoid_ocp

    return _goal_ellipsoid_ocp(3, 20)[0]


def basic_problem():
    """BASELINE config 2's planner OCP (``configuration_basic`` at
    ``default_settings()``: N=30, 4 obstacles) and one problem on a straight
    path from rest at 1 m/s, the golden's two obstacles ahead and two far
    off: ``(ocp, P (N, npar), x0, z_init)``, numpy f64. S1's counts
    (``ops/roofline.py::S1_BASIC``) are taken here."""
    from ..factory import configuration_basic
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings()
    ocp = build_ocp(*configuration_basic(settings), settings)
    idx, N = ocp.registry.save_map(), ocp.N
    P = np.zeros((N, ocp.npar))
    w = settings["weights"]
    for name in ("acceleration", "angular_velocity", "velocity",
                 "reference_velocity", "contour", "lag", "terminal_angle",
                 "terminal_contouring"):
        P[:, idx[name]] = w[name]
    for i in range(settings["contouring"]["num_segments"]):
        P[:, idx[f"spline_x{i}_c"]] = 1.0  # the straight path x(s) = s
        P[:, idx[f"spline{i}_start"]] = 5.0 * i
    P[:, idx["ego_disc_radius"]] = 0.325
    for i, (ox, oy) in enumerate([(2.5, 0.3), (4.5, -0.4), (30.0, 20.0),
                                  (40.0, -20.0)]):
        P[:, idx[f"ellipsoid_obst_{i}_x"]] = ox
        P[:, idx[f"ellipsoid_obst_{i}_y"]] = oy
        P[:, idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[:, idx[f"ellipsoid_obst_{i}_r"]] = 0.3
    x0 = np.array([0.0, 0.0, 0.0, 1.0, 0.0])
    z_init = np.zeros((N + 1, ocp.nvar))
    z_init[:, ocp.nu:] = x0
    return ocp, P, x0, z_init


def goal_demo_modules(settings):
    """The robot of the JAX package's ``examples/demo_fleet_processes.py``:
    ``(model, modules)`` with MPCBase on a and w, the goal and ellipsoidal
    obstacles on ``SecondOrderUnicycleModel``."""
    from ..models import SecondOrderUnicycleModel
    from ..modules import (EllipsoidConstraintModule, GoalModule,
                           ModuleManager, MPCBaseModule)

    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(GoalModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    return SecondOrderUnicycleModel(), mm


def goal_demo_problem(N=10):
    """The demo robot's OCP (``goal_demo_modules`` at N, 2 obstacles, goal
    weight 5) and one problem: from (0, 0) at 0.5 m/s towards the goal
    (4, 0.5), one obstacle near the straight line to it and one far off:
    ``(ocp, P (N, npar), x0, z_init)``, numpy f64. S1's counts
    (``ops/roofline.py::S1_DEMO``) are taken here at N=10."""
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=2, weights={"goal": 5.0})
    ocp = build_ocp(*goal_demo_modules(settings), settings)
    idx = ocp.registry.save_map()
    P = np.zeros((N, ocp.npar))
    w = settings["weights"]
    for name in ("acceleration", "angular_velocity"):
        P[:, idx[name]] = w[name]
    P[:, idx["goal_weight"]] = 5.0
    P[:, idx["goal_x"]], P[:, idx["goal_y"]] = 4.0, 0.5
    P[:, idx["ego_disc_radius"]] = 0.325
    for i, (ox, oy) in enumerate([(1.2, 0.25), (30.0, 30.0)]):
        P[:, idx[f"ellipsoid_obst_{i}_x"]] = ox
        P[:, idx[f"ellipsoid_obst_{i}_y"]] = oy
        P[:, idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[:, idx[f"ellipsoid_obst_{i}_r"]] = 0.3
    x0 = np.array([0.0, 0.0, 0.0, 0.5])
    z_init = np.zeros((N + 1, ocp.nvar))
    z_init[:, ocp.nu:] = x0
    return ocp, P, x0, z_init


#: The gate by flavour: the golden (inputs and CPU-f64 solve), the committed
#: CPU-f64 controls, the OCP and the prefix of its operation counts in
#: ``ops/roofline.py``.
GATE_FLAVOURS = {
    "goal": ("goal_tracking_3obs.npz", "validate_goal_U64.npy", goal_ocp,
             "GOAL"),
    "contouring": ("contouring_2obs.npz", "validate_contouring_U64.npy",
                   lambda: basic_ocp(15, 2), "GATE"),
}


def gate_inputs(flavour: str):
    """``(ocp, P, x0, z_init, U64)`` of one flavour of the gate: the
    golden's inputs (f64 numpy) and the committed CPU-f64 controls."""
    golden, u64, make_ocp, _ = GATE_FLAVOURS[flavour]
    gold = np.load(os.path.join(ROOT, "tests", "golden", golden))
    U64 = np.load(os.path.join(ROOT, "tests", "golden", u64))
    return make_ocp(), gold["P"], gold["x0"], gold["z_init"], U64
