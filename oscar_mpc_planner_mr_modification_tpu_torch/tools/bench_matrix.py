"""BASELINE's five configurations as fleet solves on the card: time per
solve, plans per second and success of each.

    python3 -m oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_matrix

Counterpart of the JAX package's ``tools/bench_matrix.py``, with its
builders, its shapes and, for the same seed, its inputs:

1. ``goal``: goal tracking with 3 ellipsoidal obstacles
   (``SecondOrderUnicycleModel``, nx=4);
2. ``contour``: MPCC contouring with 3 ellipsoidal obstacles (nx=5);
3. ``ccmpc``: CC-MPC, 3 Gaussian chance constraints on the contouring model;
4. ``tmpc``: the T-MPC++ fleet of ``bench.py`` (9 planners per plan);
5. ``shmpc``: SH-MPC, 24 scenario halfspaces softened by the slack state
   (nx=6, m=40).

Each runs a B-plan fleet solve (``BENCH_MATRIX_B``, 512; ``BENCH_N``, 20) at
the evaluators' operating point (schedule 2x3+2x5+2x8, Gershgorin, last
iterate, f32) on the backend that ``BENCH_MATRIX_BACKEND`` names
(``"fused"``, kernel B2, by default; ``"pallas"``, kernel B1 per SQP
iteration). There is no fallback: a backend that does not cover an OCP
raises. Prints one JSON line: per configuration the median ms per solve
(CUDA events, inputs on the card), plans/s, success, QP rows per stage and
the backend, with the card's name and power limit (``nvidia-smi``).
:func:`cases` builds the inputs, which ``chip_smoke.py`` drives too.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# The JAX tool's operating point is the evaluators' (2x3+2x5+2x8,
# Gershgorin, last iterate).
from ..parallel.rollout import _default_rollout_config as matrix_config
from .common import card_line, cuda_time_ms, require_card


def _straight_spline(P, idx, settings):
    for i in range(settings["contouring"]["num_segments"]):
        P[..., idx[f"spline_x{i}_c"]] = 1.0
        P[..., idx[f"spline{i}_start"]] = 5.0 * i


def build_goal(N, B, rng):
    from ..models import SecondOrderUnicycleModel
    from ..modules import (EllipsoidConstraintModule, GoalModule,
                           ModuleManager, MPCBaseModule)
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=3)
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(GoalModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    ocp = build_ocp(SecondOrderUnicycleModel(), mm, settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    P[..., idx["acceleration"]] = 0.34
    P[..., idx["angular_velocity"]] = 0.85
    P[..., idx["goal_weight"]] = 1.0
    P[..., idx["goal_x"]] = rng.uniform(4.0, 6.0, B)[:, None]
    P[..., idx["goal_y"]] = rng.uniform(-1.5, 1.5, B)[:, None]
    P[..., idx["ego_disc_radius"]] = 0.325
    for i, (ox, oy) in enumerate([(2.0, 0.4), (3.5, 1.2), (4.5, 0.2)]):
        P[..., idx[f"ellipsoid_obst_{i}_x"]] = ox
        P[..., idx[f"ellipsoid_obst_{i}_y"]] = oy
        P[..., idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[..., idx[f"ellipsoid_obst_{i}_r"]] = 0.3
    x0 = np.tile(np.array([0.0, 0.0, 0.0, 0.5], np.float32), (B, 1))
    z0 = np.zeros((B, N + 1, ocp.nvar), dtype=np.float32)
    z0[:, :, ocp.nu:] = x0[:, None, :]
    return ocp, P, x0, z0


def _contouring_base(N, B, constraint_module, n_obstacles=3):
    from ..models import ContouringSecondOrderUnicycleModel
    from ..modules import ContouringModule, ModuleManager, MPCBaseModule
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=n_obstacles)
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    base.weigh_variable("v", ["velocity", "reference_velocity"],
                        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    mm.add_module(ContouringModule(settings))
    mm.add_module(constraint_module(settings))
    ocp = build_ocp(ContouringSecondOrderUnicycleModel(), mm, settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    w = settings["weights"]
    for name in ("acceleration", "angular_velocity", "velocity",
                 "reference_velocity", "contour", "lag", "terminal_angle",
                 "terminal_contouring"):
        P[..., idx[name]] = w[name]
    _straight_spline(P, idx, settings)
    P[..., idx["ego_disc_radius"]] = 0.325
    x0 = np.tile(np.array([0.0, 0.0, 0.0, 1.0, 0.0], np.float32), (B, 1))
    z0 = np.zeros((B, N + 1, ocp.nvar), dtype=np.float32)
    z0[:, :, ocp.nu:] = x0[:, None, :]
    z0[:, :, ocp.nu] = np.arange(N + 1)[None] * 0.2
    z0[:, :, ocp.nu + 4] = z0[:, :, ocp.nu]
    return ocp, idx, P, x0, z0


def build_contour(N, B, rng):
    from ..modules import EllipsoidConstraintModule

    ocp, idx, P, x0, z0 = _contouring_base(N, B, EllipsoidConstraintModule)
    for i in range(3):
        P[..., idx[f"ellipsoid_obst_{i}_x"]] = rng.uniform(2.0, 7.0, B)[:, None]
        P[..., idx[f"ellipsoid_obst_{i}_y"]] = rng.uniform(-1.2, 1.2, B)[:, None]
        P[..., idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[..., idx[f"ellipsoid_obst_{i}_r"]] = 0.3
        P[:, 0, idx[f"ellipsoid_obst_{i}_x"]] = 50.0
    return ocp, P, x0, z0


def build_ccmpc(N, B, rng, n_obstacles=3):
    """The CC-MPC fleet; ``n_obstacles=6`` at B=256 is BASELINE config 3's
    own size (``BASELINE.json`` ``configs[2]``)."""
    from ..modules import GaussianConstraintModule

    ocp, idx, P, x0, z0 = _contouring_base(N, B, GaussianConstraintModule,
                                           n_obstacles)
    for i in range(n_obstacles):
        P[..., idx[f"gaussian_obst_{i}_x"]] = rng.uniform(2.5, 7.0, B)[:, None]
        P[..., idx[f"gaussian_obst_{i}_y"]] = rng.uniform(-1.2, 1.2, B)[:, None]
        P[..., idx[f"gaussian_obst_{i}_major"]] = 0.2
        P[..., idx[f"gaussian_obst_{i}_minor"]] = 0.15
        P[..., idx[f"gaussian_obst_{i}_risk"]] = 0.05
        P[..., idx[f"gaussian_obst_{i}_r"]] = 0.3
        P[:, 0, idx[f"gaussian_obst_{i}_x"]] = 50.0
    return ocp, P, x0, z0


def build_shmpc(N, B, rng):
    from ..factory import configuration_safe_horizon
    from ..modules.scenario_constraints import N_SCENARIO_CONSTRAINTS
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N)
    ocp = build_ocp(*configuration_safe_horizon(settings), settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    P[..., idx["acceleration"]] = 0.34
    P[..., idx["angular_velocity"]] = 0.85
    P[..., idx["contour"]] = 0.05
    P[..., idx["lag"]] = 0.75
    P[..., idx["velocity"]] = 0.55
    P[..., idx["reference_velocity"]] = 1.0
    P[..., idx["slack"]] = 1e4
    _straight_spline(P, idx, settings)
    for i in range(N_SCENARIO_CONSTRAINTS):
        P[..., idx[f"disc_0_scenario_constraint_{i}_a1"]] = 1.0
        P[..., idx[f"disc_0_scenario_constraint_{i}_b"]] = 1.0e4
    # Two active walls per instance (a random corridor)
    off = rng.uniform(1.2, 2.5, B)[:, None]
    P[..., idx["disc_0_scenario_constraint_0_a1"]] = 0.0
    P[..., idx["disc_0_scenario_constraint_0_a2"]] = 1.0
    P[..., idx["disc_0_scenario_constraint_0_b"]] = off
    P[..., idx["disc_0_scenario_constraint_1_a1"]] = 0.0
    P[..., idx["disc_0_scenario_constraint_1_a2"]] = -1.0
    P[..., idx["disc_0_scenario_constraint_1_b"]] = off
    x0 = np.zeros((B, ocp.nx), dtype=np.float32)
    x0[:, 3] = 1.0
    z0 = np.zeros((B, N + 1, ocp.nvar), dtype=np.float32)
    z0[:, :, ocp.nu + 3] = 1.0
    z0[:, :, ocp.nu] = np.arange(N + 1)[None] * 0.2
    z0[:, :, ocp.nu + 4] = z0[:, :, ocp.nu]
    return ocp, P, x0, z0


def build_tmpc(N, B):
    """``bench.py``'s fleet (seed 0), flat over plans x 9 planners."""
    from ..benchmarks import build_tmpc_fleet, tmpc_bench_ocp

    ocp, settings = tmpc_bench_ocp(N=N, n_paths=8)
    params, xinit, z_init, _ = build_tmpc_fleet(ocp, settings, B)
    Pq = params.shape[1]
    return (ocp, params.reshape(B * Pq, *params.shape[2:]),
            np.repeat(xinit, Pq, axis=0),
            z_init.reshape(B * Pq, *z_init.shape[2:]))


def build_lmpcc(N, B, rng):
    """The LMPCC fleet (``factory.configuration_lmpcc``: goal tracking with
    3 ellipsoidal obstacles on the contouring unicycle; its
    PathReferenceVelocity parameters carry the constant reference velocity
    and cost nothing). Not one of BASELINE's five."""
    from ..factory import configuration_lmpcc
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=3)
    ocp = build_ocp(*configuration_lmpcc(settings), settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    P[..., idx["acceleration"]] = 0.34
    P[..., idx["angular_velocity"]] = 0.85
    P[..., idx["goal_weight"]] = 1.0
    P[..., idx["goal_x"]] = rng.uniform(5.0, 7.0, B)[:, None]
    P[..., idx["goal_y"]] = rng.uniform(-1.5, 1.5, B)[:, None]
    P[..., idx["ego_disc_radius"]] = 0.325
    for i in range(settings["contouring"]["num_segments"]):
        P[..., idx[f"spline_v{i}_d"]] = settings["weights"][
            "reference_velocity"]
    for i in range(3):
        P[..., idx[f"ellipsoid_obst_{i}_x"]] = rng.uniform(2.0, 4.5, B)[:, None]
        P[..., idx[f"ellipsoid_obst_{i}_y"]] = rng.uniform(-1.2, 1.2, B)[:, None]
        P[..., idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[..., idx[f"ellipsoid_obst_{i}_r"]] = 0.3
        P[:, 0, idx[f"ellipsoid_obst_{i}_x"]] = 50.0
    x0 = np.tile(np.array([0.0, 0.0, 0.0, 0.5, 0.0], np.float32), (B, 1))
    z0 = np.zeros((B, N + 1, ocp.nvar), dtype=np.float32)
    z0[:, :, ocp.nu:] = x0[:, None, :]
    return ocp, P, x0, z0


def build_dynvref(N, plans):
    """``bench.py``'s T-MPC fleet on the OCP with the dynamic velocity
    reference (:data:`..benchmarks.VREF_RAMP`: 2.0 m/s falling to 0.5 m/s
    along the path), 7 guided planners and 1 unguided per plan, flat over
    plans x 8 planners. Not one of BASELINE's five."""
    from ..benchmarks import build_tmpc_fleet, tmpc_bench_ocp

    ocp, settings = tmpc_bench_ocp(N=N, n_paths=7,
                                   dynamic_velocity_reference=True)
    params, xinit, z_init, _ = build_tmpc_fleet(ocp, settings, plans)
    Pq = params.shape[1]
    return (ocp, params.reshape(plans * Pq, *params.shape[2:]),
            np.repeat(xinit, Pq, axis=0),
            z_init.reshape(plans * Pq, *z_init.shape[2:]))


def _curved_spline(P, idx, settings, B, rng, seg=8.0):
    """A path y = k x^2 / 2 along x, its curvature k ~ U(-0.05, 0.05) per
    problem (radius >= 20 m), as cubic segments of ``seg`` m in local
    coordinates."""
    k = rng.uniform(-0.05, 0.05, B)[:, None]
    for i in range(settings["contouring"]["num_segments"]):
        s0 = seg * i
        P[..., idx[f"spline_x{i}_c"]] = 1.0
        P[..., idx[f"spline_x{i}_d"]] = s0
        P[..., idx[f"spline_y{i}_b"]] = k / 2.0
        P[..., idx[f"spline_y{i}_c"]] = k * s0
        P[..., idx[f"spline_y{i}_d"]] = k * s0 * s0 / 2.0
        P[..., idx[f"spline{i}_start"]] = s0
    return k


def _along_x(ocp, B, N, v0, dt=0.2):
    """x0 at rest on the path's start at speed v0, and z0 that state
    carried along x at v0 (x and the spline state)."""
    m = ocp.model
    x0 = np.zeros((B, ocp.nx), dtype=np.float32)
    x0[:, m.state_index("v")] = v0
    z0 = np.zeros((B, N + 1, ocp.nvar), dtype=np.float32)
    z0[:, :, ocp.nu:] = x0[:, None, :]
    for name in ("x", "spline"):
        z0[:, :, m.var_index(name)] = np.arange(N + 1)[None] * v0 * dt
    return x0, z0


def _ellipsoids(P, idx, B, rng, n, x_range):
    for i in range(n):
        P[..., idx[f"ellipsoid_obst_{i}_x"]] = rng.uniform(*x_range, B)[:, None]
        P[..., idx[f"ellipsoid_obst_{i}_y"]] = rng.uniform(-1.5, 1.5, B)[:, None]
        P[..., idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[..., idx[f"ellipsoid_obst_{i}_r"]] = 0.3
        P[:, 0, idx[f"ellipsoid_obst_{i}_x"]] = 50.0


def _weights(P, idx, settings, names):
    for name in names:
        P[..., idx[name]] = settings["weights"][name]


def build_bicycle(N, B, rng, curvature_aware=False, road_width=False):
    """The bicycle fleet (``factory.configuration_bicycle`` at
    ``default_settings(N=N)``: 4 ellipsoids; nx=6, nu=3 with the slack
    input), its curvature-aware variant, or with ``road_width`` the
    road-width rows of ``ContouringConstraintModule`` added (widths 1.5-3.0
    m on each side): on curved paths (:func:`_curved_spline`) at 3 m/s.
    Not one of BASELINE's five."""
    from ..factory import configuration_bicycle
    from ..modules import ContouringConstraintModule
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N)
    model, mm = configuration_bicycle(settings, curvature_aware)
    if road_width:
        mm.add_module(ContouringConstraintModule(settings))
    ocp = build_ocp(model, mm, settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    _weights(P, idx, settings, (
        "acceleration", "angular_velocity", "slack", "velocity",
        "reference_velocity", "contour", "lag", "terminal_angle",
        "terminal_contouring"))
    _curved_spline(P, idx, settings, B, rng)
    P[..., idx["ego_disc_radius"]] = 1.0
    _ellipsoids(P, idx, B, rng, settings["max_obstacles"], (6.0, 20.0))
    if road_width:
        for i in range(settings["contouring"]["num_segments"]):
            for side in ("left", "right"):
                P[..., idx[f"width_{side}{i}_d"]] = rng.uniform(
                    1.5, 3.0, B)[:, None]
    x0, z0 = _along_x(ocp, B, N, 3.0)
    return ocp, P, x0, z0


def ca_unicycle_modules(settings):
    """The curvature-aware unicycle (``ContouringSecondOrderUnicycleModel
    CurvatureAware``) with MPCBase weighing a and w, the CA-MPC contouring
    cost and ellipsoid obstacle constraints."""
    from ..models import ContouringSecondOrderUnicycleModelCurvatureAware
    from ..modules import (CurvatureAwareContouringModule,
                           EllipsoidConstraintModule, ModuleManager,
                           MPCBaseModule)

    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(CurvatureAwareContouringModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    return ContouringSecondOrderUnicycleModelCurvatureAware(), mm


def build_ca_unicycle(N, B, rng):
    """The CA-MPC fleet (:func:`ca_unicycle_modules`, 3 ellipsoids) on
    curved paths at 1.5 m/s. Not one of BASELINE's five."""
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=3)
    ocp = build_ocp(*ca_unicycle_modules(settings), settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    _weights(P, idx, settings, (
        "acceleration", "angular_velocity", "velocity", "reference_velocity",
        "contour", "terminal_angle", "terminal_contouring"))
    _curved_spline(P, idx, settings, B, rng, seg=5.0)
    P[..., idx["ego_disc_radius"]] = 0.325
    _ellipsoids(P, idx, B, rng, 3, (2.0, 7.0))
    x0, z0 = _along_x(ocp, B, N, 1.5)
    return ocp, P, x0, z0


def corridor_points(half_width, length=12.0, spacing=0.25):
    """Occupied points of two walls at y = +-half_width along x in [0,
    length]: a corridor costmap as (n, 2) world points."""
    xs = np.arange(0.0, length + 1e-9, spacing)
    return np.concatenate([np.stack([xs, np.full_like(xs, y)], axis=1)
                           for y in (half_width, -half_width)])


def build_decomp(N, B, rng):
    """The decomp fleet: ``factory.configuration_no_obstacles`` plus
    ``DecompConstraintModule`` (12 halfspaces per stage) at 1 m/s down
    corridors of half-width 1.0-2.0 m, each problem's halfspaces decomposed
    (``EllipsoidDecomp2D``) around its warm start's path, far-away dummies
    where a stage has fewer. Not one of BASELINE's five."""
    from ..factory import configuration_no_obstacles
    from ..modules import DecompConstraintModule
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = default_settings(N=N, max_obstacles=0)
    model, mm = configuration_no_obstacles(settings)
    decomp = mm.add_module(DecompConstraintModule(settings))
    ocp = build_ocp(model, mm, settings)
    idx = ocp.registry.save_map()
    P = np.zeros((B, N, ocp.npar), dtype=np.float32)
    _weights(P, idx, settings, (
        "acceleration", "angular_velocity", "velocity", "reference_velocity",
        "contour", "lag", "terminal_angle", "terminal_contouring"))
    _straight_spline(P, idx, settings)
    for i in range(settings["contouring"]["num_segments"]):
        P[..., idx[f"spline_x{i}_d"]] = 5.0 * i
    x0, z0 = _along_x(ocp, B, N, 1.0)
    rows = decomp.max_constraints
    names = [[decomp._constraint_name(i, 0) + f"_{c}" for i in range(rows)]
             for c in ("a1", "a2", "b")]
    for (a1, a2, b) in zip(*names):
        P[..., idx[a1]], P[..., idx[b]] = 1.0, 1000.0
    half = rng.uniform(1.0, 2.0, B)
    path = np.stack([z0[0, :N, ocp.nu], np.zeros(N)], axis=1).astype(float)
    for j in range(B):
        polys = decomp.decomp.dilate_path(path, corridor_points(half[j]))
        for k in range(1, N):
            for i, (a, b) in enumerate(polys[k][:rows]):
                P[j, k, idx[names[0][i]]] = a[0]
                P[j, k, idx[names[1][i]]] = a[1]
                P[j, k, idx[names[2][i]]] = b
    return ocp, P, x0, z0


def cases(N=20, B=512, seed=0) -> dict:
    """name -> (ocp, P (problems, N, npar), x0, z0), numpy f32: the JAX
    tool's builders in its order on one generator, so that the inputs equal
    its own; the T-MPC fleet has 9 problems per plan."""
    rng = np.random.default_rng(seed)
    out = {name: build(N, B, rng) for name, build in (
        ("goal", build_goal), ("contour", build_contour),
        ("ccmpc", build_ccmpc), ("shmpc", build_shmpc))}
    out["tmpc"] = build_tmpc(N, B)
    return out


def run_case(ocp, arrays, backend, device, plans):
    """``(result dict, fleet solve, inputs on the card)`` of one
    configuration: the success of one solve and its median time over 6."""
    from ..ops.sqp import make_fleet_sqp_solver

    fleet = make_fleet_sqp_solver(ocp, matrix_config(), dtype=torch.float32,
                                  device=device, backend=backend)
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)
    out = fleet(*args)
    success = out.success.float().mean().item()
    ms, _ = cuda_time_ms(lambda: fleet(*args), reps=6, warmup=1)
    return dict(ms=ms, plans_per_s=plans / ms * 1e3, success=success,
                m_rows=len(ocp.ineq_row_spec()), backend=backend), fleet, args


def main():
    require_card("bench_matrix")
    N = int(os.environ.get("BENCH_N", "20"))
    B = int(os.environ.get("BENCH_MATRIX_B", "512"))
    backend = os.environ.get("BENCH_MATRIX_BACKEND", "fused")
    results = {"batch": B, "horizon": N, "card": card_line(),
               "device": torch.cuda.get_device_name(0)}
    for name, (ocp, *arrays) in cases(N, B).items():
        r, _, _ = run_case(ocp, arrays, backend, "cuda", B)
        results.update({f"{name}_{k}": v for k, v in r.items()})
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
