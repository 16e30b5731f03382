"""Closed-loop Monte-Carlo evaluation on the device.

Counterpart of the JAX package's ``parallel/rollout.py``: B closed-loop
episodes advance together, per tick obstacle prediction -> per-stage
parameter fill -> one batched SQP solve -> first-control application
through the model dynamics -> obstacle propagation -> collision and
progress bookkeeping. The tick loop is a Python loop of device work: it
reads nothing back between ticks, and the caller reads the metrics once
after the last tick. On a CUDA device the default backend is the fused
kernel, one launch per tick.

The evaluators, each with its scene sampler:

- :func:`make_batch_rollout` (BASELINE config 1: goal tracking on
  ``SecondOrderUnicycleModel`` among constant-velocity ellipsoidal
  obstacles), :func:`sample_scenes`;
- :func:`make_multirobot_rollout`: B episodes of R robots that plan against
  each other's exchanged plans, with full (``comm="always"``) or
  event-triggered (``comm="triggered"``) communication,
  :func:`antipodal_circle_scenes`;
- :func:`make_tmpc_rollout`: closed-loop T-MPC++, ``n_paths`` guided
  planners and one unguided per episode and tick, fair-cost selection with
  a consistency preference, :func:`tmpc_scenes`;
- :func:`make_contouring_rollout` (BASELINE config 2: the contouring model
  with ellipsoidal obstacles along a straight reference path; with
  ``constraints="gaussian"`` BASELINE config 3, CC-MPC's Gaussian chance
  constraints), with :func:`contouring_scenes`, the scene sampler of the JAX
  package's ``tools/bench_rollout.py``.

Each tick is one fleet solve of every episode's problems (B, B x R or
B x (n_paths + 1)); with ``backend="fused"`` on a CUDA device, one launch
of kernel B2, whose fleet solver raises for an OCP that the kernel does not
cover: nothing falls back to another backend.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..ops.sqp import SQPConfig, make_fleet_sqp_solver

# ---------------------------------------------------------------------------
# Shared tick machinery
# ---------------------------------------------------------------------------
DUMMY_XY = 50.0  # position of the k=0 dummy obstacle


def _default_rollout_config() -> SQPConfig:
    """The fleet operating point of the evaluators: a 3-phase inexact-SQP
    ramp with Gershgorin PSD-ization, last iterate."""
    return SQPConfig(n_sqp=6, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                     reg_eps=1e-4, regularization="gershgorin",
                     track_best=False,
                     qp_iter_schedule=((2, 3), (2, 5), (2, 8)))


def _resolve_backend(backend: str, device) -> str:
    """``"auto"`` -> ``"fused"`` (kernel B2) on a CUDA device, ``"xla"``
    (the plain single-instance solve) elsewhere; decided when the
    evaluator is built, never on an exception."""
    if backend != "auto":
        return backend
    return "fused" if torch.device(device).type == "cuda" else "xla"


def _ellipsoid_statics(base: np.ndarray, idx, n_obstacles: int,
                       obstacle_radius: float) -> None:
    """Static per-obstacle ellipsoid columns: an axis-aligned unit ellipse,
    chi = 1, radius ``obstacle_radius``."""
    for i in range(n_obstacles):
        base[idx[f"ellipsoid_obst_{i}_psi"]] = 0.0
        base[idx[f"ellipsoid_obst_{i}_major"]] = 0.0
        base[idx[f"ellipsoid_obst_{i}_minor"]] = 0.0
        base[idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        base[idx[f"ellipsoid_obst_{i}_r"]] = obstacle_radius


def _cv_prediction(obs, obs_vel, stage_t):
    """(B, N, n_obs, 2) constant-velocity prediction, stage k at k*dt (one
    rounding per element, as XLA's fused multiply-add gives it)."""
    return torch.addcmul(obs[:, None], obs_vel[:, None],
                         stage_t[None, :, None, None])


def _first_control_or_brake(success, z, x, iv, nu, dt):
    """First-stage controls of the accepted iterate; a failed solve brakes
    toward standstill (stopping at v = 0, never reversing). Any leading
    batch shape."""
    v = x[..., iv]
    brake = torch.stack([torch.clamp(-v / dt, -2.0, 2.0), torch.zeros_like(v)],
                        dim=-1)
    return torch.where(success[..., None], z[..., 0, :nu], brake)


def _shift_forward(z, success, Z0, axis=1):
    """Shift-forward warm start, reset to the stationary seed after a failed
    solve."""
    last = z.narrow(axis, z.shape[axis] - 1, 1)
    shifted = torch.cat([z.narrow(axis, 1, z.shape[axis] - 1), last],
                        dim=axis)
    keep = success.reshape(success.shape + (1,) * (z.dim() - success.dim()))
    return torch.where(keep, shifted, Z0)


def _min_obstacle_distance(obs_new, x_new):
    """(B,) smallest centre distance from the robot to an obstacle."""
    return torch.amin(torch.linalg.vector_norm(
        obs_new - x_new[:, None, :2], dim=-1), dim=1)


def _make_spline_window_fill(idx, n_seg: int, seg_len: float,
                             path_len: float):
    """The sliding window of the straight path x(s) = s: the ``n_seg``
    consecutive segments from the robot's current one. Returns
    ``fill(P, s_anchor)``, which writes them into P (B, ..., npar) in place
    for s_anchor (B,) and returns P."""

    def fill(P, s_anchor):
        first = torch.clamp(torch.floor(s_anchor / seg_len), 0.0,
                            path_len / seg_len - 1.0)
        start0 = first.reshape((-1,) + (1,) * (P.dim() - 2))
        for i in range(n_seg):
            start = (start0 + i) * seg_len
            P[..., idx[f"spline_x{i}_c"]] = 1.0
            P[..., idx[f"spline{i}_start"]] = start
            P[..., idx[f"spline_x{i}_d"]] = start
        return P

    return fill


# ---------------------------------------------------------------------------
# Goal tracking (BASELINE config 1)
# ---------------------------------------------------------------------------
class RolloutMetrics(NamedTuple):
    reached: torch.Tensor  # (B,) bool: came within goal_reached_dist of goal
    collided: torch.Tensor  # (B,) bool: any tick with disc overlap
    solve_success_rate: torch.Tensor  # (B,) mean per-tick solver success
    min_obstacle_dist: torch.Tensor  # (B,) min centre distance over episode
    final_state: torch.Tensor  # (B, nx)
    mean_cost: torch.Tensor  # (B,) mean objective over ticks (0 if failed)


def _goal_ellipsoid_ocp(n_obstacles: int, N: int, settings=None):
    """BASELINE config 1's OCP: MPCBase weighing a and w, the goal cost and
    ``n_obstacles`` ellipsoids on ``SecondOrderUnicycleModel``."""
    from ..models import SecondOrderUnicycleModel
    from ..modules import (EllipsoidConstraintModule, GoalModule,
                           ModuleManager, MPCBaseModule)
    from ..solver import build_ocp
    from ..utils import default_settings

    settings = settings or default_settings(N=N, max_obstacles=n_obstacles)
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(GoalModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    return build_ocp(SecondOrderUnicycleModel(), mm, settings), settings


def _goal_base(ocp, settings, n_obstacles, obstacle_radius):
    """The goal OCP's static parameter row: weights, disc, ellipsoids."""
    idx = ocp.registry.save_map()
    w = settings["weights"]
    base = np.zeros(ocp.npar)
    base[idx["acceleration"]] = w["acceleration"]
    base[idx["angular_velocity"]] = w["angular_velocity"]
    base[idx["goal_weight"]] = w.get("goal", 1.0)
    base[idx["ego_disc_radius"]] = float(settings["robot_radius"])
    base[idx["ego_disc_0_offset"]] = 0.0
    _ellipsoid_statics(base, idx, n_obstacles, obstacle_radius)
    return base


def make_batch_rollout(n_obstacles: int = 3, N: int = 20, n_ticks: int = 60,
                       config: SQPConfig = None, dtype=torch.float32,
                       backend: str = "auto", settings=None,
                       obstacle_radius: float = 0.3,
                       goal_reached_dist: float = 1.0, *, device="cuda"):
    """The goal-tracking evaluator (BASELINE config 1) on ``device``.

    Returns ``(rollout, ocp)`` where ``rollout(x0 (B, nx), goal (B, 2),
    obs0 (B, n_obs, 2), obs_vel (B, n_obs, 2)) -> RolloutMetrics`` advances
    all B episodes ``n_ticks`` control periods, one fleet solve per tick.
    ``backend``, ``rollout.backend``, ``.fleet_solve`` and ``.config`` as
    in :func:`make_contouring_rollout`; ``rollout.first_tick_params(x0,
    goal, obs0, obs_vel)`` is the first tick's (B, N, npar) buffer.
    """
    device = torch.device(device)
    ocp, settings = _goal_ellipsoid_ocp(n_obstacles, N, settings)
    config = config or _default_rollout_config()
    backend = _resolve_backend(backend, device)
    solve = make_fleet_sqp_solver(ocp, config, dtype=dtype, device=device,
                                  backend=backend)

    idx = ocp.registry.save_map()
    npar, nvar, nu = ocp.npar, ocp.nvar, ocp.nu
    dt = ocp.dt
    model = ocp.model
    robot_radius = float(settings["robot_radius"])
    iv = model.state_index("v")

    def dev(x, dt_=dtype):
        return torch.as_tensor(x, dtype=dt_, device=device)

    base = dev(_goal_base(ocp, settings, n_obstacles, obstacle_radius))
    gx, gy = idx["goal_x"], idx["goal_y"]
    ox_cols = dev([idx[f"ellipsoid_obst_{i}_x"] for i in range(n_obstacles)],
                  torch.long)
    oy_cols = dev([idx[f"ellipsoid_obst_{i}_y"] for i in range(n_obstacles)],
                  torch.long)
    stage_t = torch.arange(N, dtype=dtype, device=device) * dt
    collision_dist = robot_radius + obstacle_radius
    dynamics = vmap(lambda xi, ui: model.discrete_dynamics(xi, ui, dt))

    def fill_params(goal, obs, obs_vel):
        """(B, N, npar): the template, the goal and the per-stage obstacle
        predictions."""
        P = base.expand(goal.shape[0], N, npar).clone()
        P[:, :, gx] = goal[:, None, 0]
        P[:, :, gy] = goal[:, None, 1]
        pred = _cv_prediction(obs, obs_vel, stage_t)
        P[:, :, ox_cols] = pred[..., 0]
        P[:, :, oy_cols] = pred[..., 1]
        return P

    def rollout(x0, goal, obs0, obs_vel):
        x, goal, obs, obs_vel = (dev(a) for a in (x0, goal, obs0, obs_vel))
        B = x.shape[0]
        Z0 = torch.zeros((B, N + 1, nvar), dtype=dtype, device=device)
        Z0[:, :, nu:] = x[:, None, :]
        Z = Z0
        succ, costs, dists, goal_d = [], [], [], []
        for _ in range(n_ticks):
            res = rollout.fleet_solve(fill_params(goal, obs, obs_vel), x, Z)
            u = _first_control_or_brake(res.success, res.z, x, iv, nu, dt)
            x = dynamics(x, u)
            obs = obs + obs_vel * dt
            Z = _shift_forward(res.z, res.success, Z0)
            succ.append(res.success)
            costs.append(res.cost)
            dists.append(_min_obstacle_distance(obs, x))
            goal_d.append(torch.linalg.vector_norm(x[:, :2] - goal, dim=1))
        succ, dists = torch.stack(succ), torch.stack(dists)
        return RolloutMetrics(
            reached=torch.any(torch.stack(goal_d) < goal_reached_dist, dim=0),
            collided=torch.any(dists < collision_dist, dim=0),
            solve_success_rate=torch.mean(succ.to(dtype), dim=0),
            min_obstacle_dist=torch.amin(dists, dim=0),
            final_state=x,
            mean_cost=torch.mean(torch.where(succ, torch.stack(costs), 0.0),
                                 dim=0))

    rollout.fleet_solve, rollout.backend, rollout.config = (solve, backend,
                                                            config)
    rollout.first_tick_params = lambda x0, goal, obs0, obs_vel: fill_params(
        dev(goal), dev(obs0), dev(obs_vel))
    return rollout, ocp


def sample_scenes(B: int, n_obstacles: int, seed: int = 0):
    """``(x0 (B, 4), goal (B, 2), obs0 (B, n_obs, 2), obs_vel (B, n_obs,
    2))`` float64 numpy crossing scenes: the robot at the origin heading +x
    at 0.5 m/s toward a goal 6-9 m ahead; obstacles crossing the corridor."""
    rng = np.random.default_rng(seed)
    nx = 4  # SecondOrderUnicycleModel: x, y, psi, v
    x0 = np.zeros((B, nx))
    x0[:, 3] = 0.5
    goal = np.stack([rng.uniform(6.0, 9.0, B), rng.uniform(-1.0, 1.0, B)],
                    axis=1)
    ox = rng.uniform(2.0, 6.0, (B, n_obstacles))
    oy = rng.uniform(-3.0, 3.0, (B, n_obstacles)) + np.where(
        rng.uniform(size=(B, n_obstacles)) < 0.5, -1.5, 1.5)
    obs0 = np.stack([ox, oy], axis=-1)
    speed = rng.uniform(0.4, 1.2, (B, n_obstacles))
    obs_vel = np.stack([rng.uniform(-0.2, 0.2, (B, n_obstacles)),
                        -np.sign(oy) * speed], axis=-1)
    return x0, goal, obs0, obs_vel


# ---------------------------------------------------------------------------
# Multi-robot joint planning (the goal OCP, robots as each other's obstacles)
# ---------------------------------------------------------------------------
class MultiRobotRolloutMetrics(NamedTuple):
    all_reached: torch.Tensor  # (B,) bool: every robot within goal distance
    reached_rate: torch.Tensor  # (B,) fraction of robots that reached
    collided: torch.Tensor  # (B,) bool: any robot-robot disc overlap
    min_robot_dist: torch.Tensor  # (B,) min pairwise centre distance
    solve_success_rate: torch.Tensor  # (B,) mean over (ticks, robots)
    final_states: torch.Tensor  # (B, R, nx)
    comm_rate: torch.Tensor  # (B,) broadcasts / (ticks * robots); 1 = always


def _multirobot_config() -> SQPConfig:
    """The joint-planning schedule, 4x4 + 4x8: robots consume each other's
    plans every tick, so looser early QP iterates propagate between them."""
    return SQPConfig(n_sqp=8, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                     reg_eps=1e-4, regularization="gershgorin",
                     track_best=False, qp_iter_schedule=((4, 4), (4, 8)))


def make_multirobot_rollout(n_robots: int = 4, N: int = 20, n_ticks: int = 60,
                            config: SQPConfig = None, dtype=torch.float32,
                            backend: str = "auto", settings=None,
                            goal_reached_dist: float = 1.0,
                            margin: float = 0.15,
                            comm: str = "always",
                            geometric_threshold: float = 0.5,
                            heartbeat_ticks: int = 10, *, device="cuda"):
    """Batched multi-robot joint planning on ``device``: each tick every
    robot solves the goal OCP with the other robots' communicated plans as
    ellipsoidal trajectory obstacles, then broadcasts its own plan; the
    B x R solves of a tick are one fleet solve.

    ``comm="always"``: every robot broadcasts every tick, and a receiver
    reads a plan shifted one stage (the shift-forward warm start is that
    plan). ``comm="triggered"``: a robot broadcasts only when its solve
    failed (the braking plan must be announced), when its new plan deviates
    more than ``geometric_threshold`` m from what the others would
    extrapolate from its last broadcast, or every ``heartbeat_ticks``;
    between broadcasts a receiver reads the stale plan advanced by its age,
    held at its terminal point past the horizon. ``comm_rate`` is the
    realized broadcast fraction. Any other ``comm`` raises ``ValueError``.
    ``margin`` widens each robot's obstacle radius for the one-tick staleness
    of exchanged plans.

    Returns ``(rollout, ocp)``; ``rollout(x0 (B, R, nx), goals (B, R, 2))
    -> MultiRobotRolloutMetrics``; ``rollout.first_tick_params(x0, goals)``
    is the first tick's (B, R, N, npar) buffer (every robot stationary at
    its start). The default config is the joint-planning schedule
    (:func:`_multirobot_config`).
    """
    if comm not in ("always", "triggered"):
        raise ValueError(f"comm must be 'always' or 'triggered', got {comm!r}")
    triggered = comm == "triggered"
    device = torch.device(device)
    R = n_robots
    n_others = R - 1
    ocp, settings = _goal_ellipsoid_ocp(n_others, N, settings)
    config = config or _multirobot_config()
    backend = _resolve_backend(backend, device)
    solve = make_fleet_sqp_solver(ocp, config, dtype=dtype, device=device,
                                  backend=backend)

    idx = ocp.registry.save_map()
    npar, nvar, nu, nx = ocp.npar, ocp.nvar, ocp.nu, ocp.nx
    dt = ocp.dt
    model = ocp.model
    robot_radius = float(settings["robot_radius"])
    iv = model.state_index("v")

    def dev(x, dt_=dtype):
        return torch.as_tensor(x, dtype=dt_, device=device)

    # a device index: a list index would upload itself on every use
    xy = dev([model.var_index("x"), model.var_index("y")], torch.long)

    base = dev(_goal_base(ocp, settings, n_others, robot_radius + margin))
    gx, gy = idx["goal_x"], idx["goal_y"]
    ox_cols = dev([idx[f"ellipsoid_obst_{i}_x"] for i in range(n_others)],
                  torch.long)
    oy_cols = dev([idx[f"ellipsoid_obst_{i}_y"] for i in range(n_others)],
                  torch.long)
    # (R, R-1): the other robots of each robot
    others = dev(np.stack([np.concatenate([np.arange(r), np.arange(r + 1, R)])
                           for r in range(R)]), torch.long)
    collision_dist = 2.0 * robot_radius
    stage_idx = torch.arange(N, device=device)
    eye = torch.eye(R, dtype=dtype, device=device) * 1e3
    dynamics = vmap(lambda xi, ui: model.discrete_dynamics(xi, ui, dt))

    def fill_params(goals, pred):
        """(B, R, N, npar): the template, each robot's goal and the others'
        plans as obstacles (pred (B, R, N, R-1, 2))."""
        P = base.expand(goals.shape[0], R, N, npar).clone()
        P[..., gx] = goals[:, :, None, 0]
        P[..., gy] = goals[:, :, None, 1]
        P[..., ox_cols] = pred[..., 0]
        P[..., oy_cols] = pred[..., 1]
        return P

    def peers(plans):
        """(B, R, K, 2) plans -> (B, R, K, R-1, 2): each robot's view of the
        others'."""
        return plans[:, others].transpose(2, 3)

    def align(Zb, age):
        """Receiver-side alignment: broadcast stage k + age serves stage k,
        held at the terminal point past the horizon. (B, R, N, 2)."""
        idxs = torch.clamp(stage_idx[None, None] + age[:, :, None], 0, N)
        return torch.gather(Zb, 2, idxs[..., None].expand(-1, -1, -1, 2))

    def rollout(x0, goals):
        X, goals = dev(x0), dev(goals)
        B = X.shape[0]
        Z0 = torch.zeros((B, R, N + 1, nvar), dtype=dtype, device=device)
        Z0[..., nu:] = X[:, :, None, :]
        Z, Zb = Z0, Z0[..., xy]  # first broadcast: stationary at the start
        age = torch.zeros((B, R), dtype=torch.long, device=device)
        n_comm = torch.zeros((B,), dtype=dtype, device=device)
        succs, min_ds, goal_ds = [], [], []
        for _ in range(n_ticks):
            if triggered:
                pred = peers(align(Zb, age))
            else:
                pred = peers(Z[..., xy])[:, :, :N]
            P = fill_params(goals, pred)
            res = rollout.fleet_solve(P.reshape(B * R, N, npar),
                                      X.reshape(B * R, nx),
                                      Z.reshape(B * R, N + 1, nvar))
            succ = res.success.reshape(B, R)
            z = res.z.reshape(B, R, N + 1, nvar)
            u = _first_control_or_brake(succ, z, X, iv, nu, dt)
            X = dynamics(X.reshape(B * R, nx),
                         u.reshape(B * R, nu)).reshape(B, R, nx)
            Z = torch.cat([z[:, :, 1:], z[:, :, -1:]], dim=2)
            # a failed robot broadcasts a stationary plan at its pose
            stay = torch.zeros_like(Z)
            stay[..., nu:] = X[:, :, None, :]
            Z = torch.where(succ[..., None, None], Z, stay)
            if triggered:
                # what would the others believe of me next tick if I stayed
                # silent (age + 1)?
                plan_pos = Z[..., xy]
                deviation = torch.amax(torch.linalg.vector_norm(
                    plan_pos[:, :, :N] - align(Zb, age + 1), dim=-1), dim=-1)
                fire = ((deviation > geometric_threshold)
                        | (age + 1 >= heartbeat_ticks) | ~succ)
                Zb = torch.where(fire[..., None, None], plan_pos, Zb)
                age = torch.where(fire, 0, age + 1)
                n_comm = n_comm + torch.sum(fire.to(dtype), dim=1)
            d = torch.linalg.vector_norm(
                X[:, :, None, :2] - X[:, None, :, :2], dim=-1) + eye
            succs.append(succ)
            min_ds.append(torch.amin(d, dim=(1, 2)))
            goal_ds.append(torch.linalg.vector_norm(X[..., :2] - goals,
                                                    dim=-1))
        min_d = torch.amin(torch.stack(min_ds), dim=0)
        reached = torch.any(torch.stack(goal_ds) < goal_reached_dist, dim=0)
        return MultiRobotRolloutMetrics(
            all_reached=torch.all(reached, dim=1),
            reached_rate=torch.mean(reached.to(dtype), dim=1),
            collided=min_d < collision_dist,
            min_robot_dist=min_d,
            solve_success_rate=torch.mean(torch.stack(succs).to(dtype),
                                          dim=(0, 2)),
            final_states=X,
            comm_rate=(n_comm / (n_ticks * R) if triggered
                       else torch.ones((B,), dtype=dtype, device=device)))

    def first_tick_params(x0, goals):
        x0 = dev(x0)
        plans = x0[:, :, None, :2].expand(-1, -1, N + 1, -1)
        return fill_params(dev(goals), peers(plans)[:, :, :N])

    rollout.fleet_solve, rollout.backend, rollout.config = (solve, backend,
                                                            config)
    rollout.first_tick_params = first_tick_params
    return rollout, ocp


def antipodal_circle_scenes(B: int, n_robots: int, radius: float = 3.0,
                            seed: int = 0):
    """``(x0 (B, R, 4), goals (B, R, 2))`` float64 numpy: robots on a circle
    heading to its centre at 0.3 m/s, each goal diametrically opposite, so
    every episode sends all robots through the centre."""
    rng = np.random.default_rng(seed)
    nx = 4
    base_ang = rng.uniform(0.0, 2.0 * np.pi, (B, 1))
    ang = base_ang + np.arange(n_robots)[None] * (2.0 * np.pi / n_robots)
    ang += rng.normal(0.0, 0.05, (B, n_robots))
    r = radius + rng.normal(0.0, 0.1, (B, n_robots))
    x0 = np.zeros((B, n_robots, nx))
    x0[..., 0] = r * np.cos(ang)
    x0[..., 1] = r * np.sin(ang)
    x0[..., 2] = ang + np.pi  # heading toward the centre and the goal
    x0[..., 3] = 0.3
    goals = -np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)
    return x0, goals


# ---------------------------------------------------------------------------
# Closed-loop T-MPC++
# ---------------------------------------------------------------------------
class TMPCRolloutMetrics(NamedTuple):
    progress: torch.Tensor  # (B,) final path progress (straight path: x)
    collided: torch.Tensor  # (B,) bool: any tick with disc overlap
    plan_success_rate: torch.Tensor  # (B,) mean per tick of "any feasible"
    planner_success_rate: torch.Tensor  # (B,) mean over (ticks, planners)
    guided_selected_rate: torch.Tensor  # (B,) ticks a guided planner won
    topology_switch_rate: torch.Tensor  # (B,) selected-signature changes
    min_obstacle_dist: torch.Tensor  # (B,)
    final_state: torch.Tensor  # (B, nx)


def _hypot(x, y):
    """sqrt(x^2 + y^2) as the JAX package computes it: max(|x|, |y|) *
    sqrt(1 + (min / max)^2), 0 where both are 0."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    out = torch.where(hi == 0, hi,
                      hi * torch.sqrt(1 + torch.square(lo / safe)))
    return torch.where(torch.isposinf(x) | torch.isposinf(y),
                       torch.full_like(out, float("inf")), out)


def passing_signature(pos, centers):
    """Per-obstacle passing side at closest approach, the Winding
    comparator's decision for a 2D pass: pos (B, P, K, 2) trajectories
    against centers (B, K, n_obs, 2) -> (B, P, n_obs) in {-1, 0, +1}, the
    sign of the trajectory's y offset from the obstacle at the first stage
    of least distance."""
    diff = pos[..., None, :] - centers[:, None]  # (B, P, K, n_obs, 2)
    d2 = torch.sum(diff**2, dim=-1)  # (B, P, K, n_obs)
    k_star = torch.argmin(d2, dim=-2, keepdim=True)  # first minimum
    return torch.sign(torch.gather(diff[..., 1], -2, k_star)[..., 0, :])


def make_tmpc_rollout(n_obstacles: int = 4, N: int = 20, n_ticks: int = 60,
                      n_paths: int = 4, config: SQPConfig = None,
                      dtype=torch.float32, backend: str = "auto",
                      obstacle_radius: float = 0.3, *, device="cuda"):
    """Closed-loop T-MPC++ on ``device``: per tick every episode runs
    ``n_paths`` guided planners, each seeded with a topology-distinct
    lateral-offset bundle and held to it by linearized topology halfspaces,
    and one unguided planner seeded with the previous winner; then the
    fair-cost selection with a consistency preference picks the executed
    plan. The B x (n_paths + 1) solves of a tick are one fleet solve on the
    fleet bench's OCP (``benchmarks.tmpc_bench_ocp``).

    Stand-ins for the host machinery, computed on the device: the guidance
    trajectories are the lateral-offset seed bundles (no PRM search); the
    topology constraints are halfspaces linearized at the seed positions
    against the per-stage obstacle centres; a homology class is the vector of
    per-obstacle passing sides at closest approach
    (:func:`passing_signature`). The consistency cost and the selection
    weight apply to guided planners whose seed signature matches the
    previous winner's.

    Returns ``(rollout, ocp)``; ``rollout(x0 (B, nx), obs0 (B, n_obs, 2),
    obs_vel (B, n_obs, 2)) -> TMPCRolloutMetrics``. Handles:
    ``rollout.first_tick_params`` / ``first_tick_seeds`` (same arguments)
    give the first tick's (B, P, N, npar) parameters and (B, P, N+1, nvar)
    seeds; with ``rollout.keep_selection_costs = True`` a run leaves its
    per-tick selection costs (n_ticks, B, P) in
    ``rollout.selection_costs``. ``backend``, ``.backend``,
    ``.fleet_solve`` and ``.config`` as in :func:`make_contouring_rollout`.
    """
    from ..benchmarks import tmpc_bench_ocp

    device = torch.device(device)
    ocp, settings = tmpc_bench_ocp(N=N, n_paths=n_paths,
                                   max_obstacles=n_obstacles)
    config = config or _default_rollout_config()
    backend = _resolve_backend(backend, device)
    solve = make_fleet_sqp_solver(ocp, config, dtype=dtype, device=device,
                                  backend=backend)

    reg = ocp.registry
    idx = reg.save_map()
    npar, nvar, nu, nx = ocp.npar, ocp.nvar, ocp.nu, ocp.nx
    dt = ocp.dt
    model = ocp.model
    w = settings["weights"]
    robot_radius = float(settings["robot_radius"])
    P_ = n_paths + 1
    n_seg = int(settings["contouring"]["num_segments"])
    seg_len = 5.0
    path_len = 5.0 * 10
    ix, iy = model.var_index("x"), model.var_index("y")
    ipsi, ivv = model.var_index("psi"), model.var_index("v")
    isp = model.var_index("spline")
    i_s, iv = model.state_index("spline"), model.state_index("v")
    sel_weight = float(settings["guidance"]["selection_weight_consistency"])
    w_cons = float(w.get("consistency", 0.0))

    def dev(x, dt_=dtype):
        return torch.as_tensor(x, dtype=dt_, device=device)

    xy = dev([ix, iy], torch.long)  # a list index would upload itself
    base_p = np.zeros(npar)
    for name in ("acceleration", "angular_velocity", "velocity",
                 "reference_velocity", "contour", "lag", "terminal_angle",
                 "terminal_contouring"):
        base_p[idx[name]] = w[name]
    base_p[idx["ego_disc_radius"]] = robot_radius
    base_p[idx["ego_disc_0_offset"]] = 0.0
    _ellipsoid_statics(base_p, idx, n_obstacles, obstacle_radius)
    # Inactive topology rows wherever the guided fill does not write (a zero
    # row would be a degenerate always-active constraint)
    a1_cols = np.asarray(reg.bundle_indices("lin_constraint_a1"))
    a2_cols = np.asarray(reg.bundle_indices("lin_constraint_a2"))
    b_cols = np.asarray(reg.bundle_indices("lin_constraint_b"))
    base_p[a1_cols] = 1.0
    base_p[b_cols] = 1.0e4
    base = dev(base_p)
    ox_cols = dev([idx[f"ellipsoid_obst_{i}_x"] for i in range(n_obstacles)],
                  torch.long)
    oy_cols = dev([idx[f"ellipsoid_obst_{i}_y"] for i in range(n_obstacles)],
                  torch.long)
    i_wc = idx["consistency_weight"]
    i_px, i_py = idx["prev_traj_x"], idx["prev_traj_y"]
    n_rows = min(n_obstacles, len(a1_cols))
    a1_rows, a2_rows, b_rows = (dev(c[:n_rows], torch.long)
                                for c in (a1_cols, a2_cols, b_cols))
    lin_radius = 1e-3 + robot_radius
    collision_dist = robot_radius + obstacle_radius

    # Lateral-offset seed bundle shapes (build_tmpc_fleet's diversification)
    lateral = np.array([((-1) ** p) * (0.4 + 0.4 * (p // 2))
                        for p in range(n_paths)] + [0.0])  # (P,)
    envelope = np.sin(np.linspace(0.0, np.pi, N + 1))  # (N+1,)
    offsets = dev(lateral[:, None] * envelope[None])  # (P, N+1)
    t_grid = torch.arange(N + 1, dtype=dtype, device=device) * dt
    decay = torch.clamp(1.0 - t_grid * (1.0 / (N * dt)), 0.0, 1.0)
    stage_t = torch.arange(N, dtype=dtype, device=device) * dt
    guided_mask = torch.arange(P_, device=device) < n_paths  # last: unguided
    cons_gate = np.zeros(N)  # consistency at stages 1..N-2
    cons_gate[1:N - 1] = 1.0
    cons_gate = dev(cons_gate)
    fill_spline_segments = _make_spline_window_fill(idx, n_seg, seg_len,
                                                    path_len)
    dynamics = vmap(lambda xi, ui: model.discrete_dynamics(xi, ui, dt))

    def prepare(x, obs, obs_vel, Z_best, prev, prev_sig, has_prev):
        """One tick's stand-ins for the host machinery before the solve:
        the seed bundle, the parameters (spline window, ellipsoid
        predictions, topology halfspaces, consistency) and the signature
        match."""
        B = x.shape[0]
        s_anchor = torch.clamp(x[:, 0], 0.0, path_len)
        x = x.clone()
        x[:, i_s] = s_anchor
        # stage k reads the obstacle at k dt; the k = 0 rows are dummies
        pred = _cv_prediction(obs, obs_vel, stage_t)
        pred[:, 0] = DUMMY_XY

        # --- warm-start seeds (B, P, N+1, nvar); a * b + c rounds once and
        # x / dt is x * (1 / dt), as XLA computes them
        v_seed = torch.clamp(x[:, iv], min=0.5)
        xs = torch.addcmul(x[:, None, None, 0], v_seed[:, None, None],
                           t_grid)  # (B, 1, N+1)
        ys = torch.addcmul(offsets[None], x[:, None, None, 1],
                           decay)  # (B, P, N+1)
        xs = xs.expand(ys.shape)
        dx = torch.gradient(xs, dim=-1)[0] * (1.0 / dt)
        dy = torch.gradient(ys, dim=-1)[0] * (1.0 / dt)
        seeds = torch.zeros((B, P_, N + 1, nvar), dtype=dtype, device=device)
        seeds[..., ix] = xs
        seeds[..., iy] = ys
        seeds[..., ipsi] = torch.atan2(dy, dx)
        seeds[..., ivv] = _hypot(dx, dy)
        seeds[..., isp] = xs
        # the unguided planner: the previous winner shifted forward
        Z_shift = torch.cat([Z_best[:, 1:], Z_best[:, -1:]], dim=1)
        seeds[:, n_paths] = torch.where(has_prev[:, None, None], Z_shift,
                                        seeds[:, n_paths])
        seeds[:, :, 0, nu:] = x[:, None, :]

        # --- parameters (B, P, N, npar)
        Pa = base.expand(B, P_, N, npar).clone()
        Pa = fill_spline_segments(Pa, s_anchor)
        Pa[..., ox_cols] = pred[:, None, ..., 0]
        Pa[..., oy_cols] = pred[:, None, ..., 1]

        # topology halfspaces of the guided planners at stages 1..N-1,
        # centres at k dt as the ellipsoid rows
        c_k = _cv_prediction(obs, obs_vel, stage_t[1:])  # (B, N-1, n_obs, 2)
        pos_g = seeds[:, :n_paths, 1:N][..., xy]  # (B, Pg, N-1, 2)
        diff = c_k[:, None, :, :n_rows] - pos_g[..., None, :]
        dist = torch.linalg.vector_norm(diff, dim=-1)  # (B, Pg, N-1, n_rows)
        ok = dist >= lin_radius + 1e-6
        a_n = diff / torch.clamp(dist, min=1e-30)[..., None]
        c_r = c_k[:, None, :, :n_rows]
        b_v = torch.addcmul(a_n[..., 0] * c_r[..., 0], a_n[..., 1],
                            c_r[..., 1]) - lin_radius
        g = Pa[:, :n_paths, 1:N]
        g[..., a1_rows] = torch.where(ok, a_n[..., 0], 1.0)
        g[..., a2_rows] = torch.where(ok, a_n[..., 1], 0.0)
        g[..., b_rows] = torch.where(ok, b_v, 1.0e4)

        # consistency on a signature match, guided planners only (the
        # unguided seed is the shifted winner: it nearly always matches)
        sig = passing_signature(seeds[:, :, 1:N][..., xy], c_k)
        matches = (torch.all(sig == prev_sig[:, None], dim=-1)
                   & has_prev[:, None] & guided_mask[None])  # (B, P)
        cons_w = matches.to(dtype) * w_cons
        Pa[..., i_wc] = cons_w[:, :, None] * cons_gate
        Pa[..., i_px] = prev[:, None, :, 0] * cons_gate
        Pa[..., i_py] = prev[:, None, :, 1] * cons_gate
        return x, seeds, Pa, c_k, matches, cons_w

    def initial_carry(x0, obs0):
        x0 = dev(x0)
        B = x0.shape[0]
        Z0 = torch.zeros((B, N + 1, nvar), dtype=dtype, device=device)
        Z0[:, :, nu:] = x0[:, None, :]
        prev0 = Z0[:, :N][..., xy]  # placeholder previous trajectory
        sig0 = torch.zeros((B, n_obstacles), dtype=dtype, device=device)
        has_prev0 = torch.zeros((B,), dtype=torch.bool, device=device)
        return (x0, dev(obs0), Z0, prev0, sig0, has_prev0), Z0

    def rollout(x0, obs0, obs_vel):
        obs_vel = dev(obs_vel)
        (x, obs, Z_best, prev, prev_sig, has_prev), Z0 = initial_carry(x0,
                                                                        obs0)
        B = x.shape[0]
        succs, any_oks, guided, switches, dists, sel = [], [], [], [], [], []
        for _ in range(n_ticks):
            x, seeds, Pa, c_k, matches, cons_w = prepare(
                x, obs, obs_vel, Z_best, prev, prev_sig, has_prev)
            res = rollout.fleet_solve(
                Pa.reshape(B * P_, N, npar),
                x[:, None].expand(B, P_, nx).reshape(B * P_, nx),
                seeds.reshape(B * P_, N + 1, nvar))
            succ = res.success.reshape(B, P_)
            z = res.z.reshape(B, P_, N + 1, nvar)
            costs = res.cost.reshape(B, P_)

            # fair-cost comparison: the realized consistency cost taken out,
            # the previously selected signature preferred
            pos_sol = z[:, :, 1:N - 1][..., xy]
            cons_cost = torch.sum((pos_sol - prev[:, None, 1:N - 1]) ** 2,
                                  dim=(-2, -1))
            costs = costs - cons_w * cons_cost
            costs = torch.where(matches, costs * sel_weight, costs)
            sel_costs = torch.where(succ, costs, float("inf"))
            best = torch.argmin(sel_costs, dim=1)  # (B,), first minimum
            any_ok = torch.any(succ, dim=1)
            z_best = z[torch.arange(B, device=device), best]
            # the carried signature is the solved winner's
            sig_sol = passing_signature(z[:, :, 1:N][..., xy], c_k)
            sig_best = sig_sol[torch.arange(B, device=device), best]

            u = _first_control_or_brake(any_ok, z_best, x, iv, nu, dt)
            x_new = dynamics(x, u)
            obs = obs + obs_vel * dt
            switch = (torch.any(sig_best != prev_sig, dim=-1) & has_prev
                      & any_ok)
            prev = torch.where(any_ok[:, None, None], z_best[:, :N][..., xy],
                               prev)
            prev_sig = torch.where(any_ok[:, None], sig_best, prev_sig)
            Z_best = torch.where(any_ok[:, None, None], z_best, Z0)
            has_prev = any_ok
            x = x_new
            succs.append(succ)
            any_oks.append(any_ok)
            guided.append(any_ok & (best < n_paths))
            switches.append(switch)
            dists.append(_min_obstacle_distance(obs, x))
            if rollout.keep_selection_costs:
                sel.append(sel_costs)
        if rollout.keep_selection_costs:
            rollout.selection_costs = torch.stack(sel)
        dists = torch.stack(dists)

        def rate(v):
            return torch.mean(torch.stack(v).to(dtype), dim=0)

        return TMPCRolloutMetrics(
            progress=torch.clamp(x[:, 0], 0.0, path_len),
            collided=torch.any(dists < collision_dist, dim=0),
            plan_success_rate=rate(any_oks),
            planner_success_rate=torch.mean(torch.stack(succs).to(dtype),
                                            dim=(0, 2)),
            guided_selected_rate=rate(guided),
            topology_switch_rate=rate(switches),
            min_obstacle_dist=torch.amin(dists, dim=0),
            final_state=x)

    def first_tick(x0, obs0, obs_vel):
        carry, _ = initial_carry(x0, obs0)
        x, obs, Z_best, prev, prev_sig, has_prev = carry
        _, seeds, Pa, _, _, _ = prepare(x, obs, dev(obs_vel), Z_best, prev,
                                        prev_sig, has_prev)
        return Pa, seeds

    rollout.fleet_solve, rollout.backend, rollout.config = (solve, backend,
                                                            config)
    rollout.keep_selection_costs = False
    rollout.first_tick_params = lambda *a: first_tick(*a)[0]
    rollout.first_tick_seeds = lambda *a: first_tick(*a)[1]
    return rollout, ocp


def tmpc_scenes(B: int, n_obstacles: int, seed: int = 0):
    """``(x0 (B, 5), obs0 (B, n_obs, 2), obs_vel (B, n_obs, 2))`` float64
    numpy crossing-corridor scenes for :func:`make_tmpc_rollout` (the fleet
    bench's distribution): the contouring unicycle at the origin at 1 m/s,
    obstacles 2-7 m ahead within 1.5 m of the path, drifting at up to 0.5
    m/s."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 5))
    x0[:, 3] = 1.0
    obs0 = np.stack([rng.uniform(2.0, 7.0, (B, n_obstacles)),
                     rng.uniform(-1.5, 1.5, (B, n_obstacles))], axis=-1)
    obs_vel = rng.uniform(-0.5, 0.5, (B, n_obstacles, 2))
    return x0, obs0, obs_vel


# ---------------------------------------------------------------------------
# Contouring (BASELINE config 2)
# ---------------------------------------------------------------------------
def contouring_scenes(B: int, n_obstacles: int, seed: int = 0):
    """``(x0 (B, 5), obs0 (B, n_obs, 2), obs_vel (B, n_obs, 2))`` float32
    numpy: the contouring scene sampler of the JAX package's
    ``tools/bench_rollout.py``. The robot starts at the origin at 0.8 m/s;
    obstacles 3-14 m ahead, 1-3.5 m to either side of the path, walking
    toward it at 0.3-1 m/s."""
    r = np.random.default_rng(seed)
    x0 = np.zeros((B, 5), np.float32)
    x0[:, 3] = 0.8
    ox = r.uniform(3.0, 14.0, (B, n_obstacles))
    oy = r.uniform(-2.5, 2.5, (B, n_obstacles)) + np.where(
        r.uniform(size=(B, n_obstacles)) < 0.5, -1.0, 1.0)
    obs0 = np.stack([ox, oy], axis=-1)
    vel = np.stack([r.uniform(-0.15, 0.15, (B, n_obstacles)),
                    -np.sign(oy) * r.uniform(0.3, 1.0, (B, n_obstacles))],
                   axis=-1)
    return x0, obs0, vel


class ContouringRolloutMetrics(NamedTuple):
    progress: torch.Tensor  # (B,) final path progress s
    collided: torch.Tensor  # (B,) bool
    max_lateral: torch.Tensor  # (B,) max |lateral deviation| from the path
    solve_success_rate: torch.Tensor  # (B,)
    min_obstacle_dist: torch.Tensor  # (B,)
    final_state: torch.Tensor  # (B, nx)


def make_contouring_rollout(n_obstacles: int = 3, N: int = 20,
                            n_ticks: int = 80, config: SQPConfig = None,
                            dtype=torch.float32, backend: str = "auto",
                            settings=None, obstacle_radius: float = 0.3,
                            per_episode_weights: tuple = (),
                            constraints: str = "ellipsoid",
                            risk: float = 0.05, sigma_step: float = 0.05, *,
                            device="cuda"):
    """Closed-loop MPCC path following on ``device`` (BASELINE config 2: the
    contouring model and ellipsoidal obstacles along the straight path
    x(s) = s; BASELINE config 3 with ``constraints="gaussian"``).

    Per tick the progress state is re-anchored to the closest path point
    (clip(x, 0, L) on this path) and the per-stage obstacle predictions are
    refilled. Returns ``(rollout, ocp)``; ``rollout(x0 (B, nx),
    obs0 (B, n_obs, 2), obs_vel (B, n_obs, 2)) -> ContouringRolloutMetrics``
    of tensors on ``device``. ``backend`` is a fleet backend of
    :func:`..ops.sqp.make_fleet_sqp_solver` or ``"auto"``
    (:func:`_resolve_backend`), recorded as ``rollout.backend``; the fleet
    solve and its config are ``rollout.fleet_solve`` and ``rollout.config``.

    ``per_episode_weights``: names of weight parameters (e.g. ``("contour",
    "reference_velocity")``) that become per-episode inputs: ``rollout``
    then takes one more (B,) array per name, in order.
    ``rollout.first_tick_params(x0, obs0, obs_vel, *weights)`` is the first
    tick's parameter buffer (B, N, npar).

    ``constraints="gaussian"`` runs the CC-MPC flavour in place of the
    ellipsoids: linear chance constraints at risk level ``risk`` against a
    per-stage uncertainty sigma_k = ``sigma_step`` sqrt(k + 1) at stage k
    (the JAX package's propagation), set once in the stage template.
    """
    from ..models import ContouringSecondOrderUnicycleModel
    from ..modules import (ContouringModule, EllipsoidConstraintModule,
                           GaussianConstraintModule, ModuleManager,
                           MPCBaseModule)
    from ..solver import build_ocp
    from ..utils import default_settings

    if constraints not in ("ellipsoid", "gaussian"):
        raise ValueError(f"constraints must be 'ellipsoid' or 'gaussian', "
                         f"got {constraints!r}")
    gaussian = constraints == "gaussian"
    device = torch.device(device)
    settings = settings or default_settings(N=N, max_obstacles=n_obstacles)
    if gaussian:
        settings["probabilistic"]["risk"] = risk
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    base.weigh_variable("v", ["velocity", "reference_velocity"],
                        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    mm.add_module(ContouringModule(settings))
    mm.add_module(GaussianConstraintModule(settings) if gaussian
                  else EllipsoidConstraintModule(settings))
    ocp = build_ocp(ContouringSecondOrderUnicycleModel(), mm, settings)

    config = config or _default_rollout_config()
    backend = _resolve_backend(backend, device)
    solve = make_fleet_sqp_solver(ocp, config, dtype=dtype, device=device,
                                  backend=backend)

    idx = ocp.registry.save_map()
    npar, nvar, nu = ocp.npar, ocp.nvar, ocp.nu
    dt = ocp.dt
    model = ocp.model
    w = settings["weights"]
    robot_radius = float(settings["robot_radius"])
    n_seg = int(settings["contouring"]["num_segments"])
    seg_len = 5.0
    path_len = 5.0 * 10  # straight path x(s) = s, long enough for any run
    i_s = model.state_index("spline")
    iv = model.state_index("v")

    base_p = np.zeros(npar)
    for name in ("acceleration", "angular_velocity", "velocity",
                 "reference_velocity", "contour", "lag", "terminal_angle",
                 "terminal_contouring"):
        base_p[idx[name]] = w[name]
    base_p[idx["ego_disc_radius"]] = robot_radius
    base_p[idx["ego_disc_0_offset"]] = 0.0
    obst = "gaussian_obst" if gaussian else "ellipsoid_obst"
    if gaussian:
        for i in range(n_obstacles):
            base_p[idx[f"gaussian_obst_{i}_risk"]] = risk
            base_p[idx[f"gaussian_obst_{i}_r"]] = obstacle_radius
    else:
        _ellipsoid_statics(base_p, idx, n_obstacles, obstacle_radius)
    base_np = np.tile(base_p, (N, 1))  # (N, npar)
    if gaussian:  # the stage-dependent sigmas
        sigma_k = sigma_step * np.sqrt(np.arange(1, N + 1))
        for i in range(n_obstacles):
            base_np[:, idx[f"gaussian_obst_{i}_major"]] = sigma_k
            base_np[:, idx[f"gaussian_obst_{i}_minor"]] = sigma_k

    def dev(x, dt_=dtype):
        return torch.as_tensor(x, dtype=dt_, device=device)

    base_stage = dev(base_np)
    ox_cols = dev([idx[f"{obst}_{i}_x"] for i in range(n_obstacles)],
                  torch.long)
    oy_cols = dev([idx[f"{obst}_{i}_y"] for i in range(n_obstacles)],
                  torch.long)
    weight_cols = [idx[name] for name in per_episode_weights]
    stage_t = torch.arange(N, dtype=dtype, device=device) * dt
    collision_dist = robot_radius + obstacle_radius
    fill_spline_segments = _make_spline_window_fill(idx, n_seg, seg_len,
                                                    path_len)
    dynamics = vmap(lambda xi, ui: model.discrete_dynamics(xi, ui, dt))

    def fill_params(s_anchor, obs, obs_vel, weight_values):
        """(B, N, npar): the stage template, the per-episode weights, the
        spline window and the obstacle predictions."""
        P = base_stage.expand(s_anchor.shape[0], N, npar).clone()
        for col, vals in zip(weight_cols, weight_values):
            P[:, :, col] = vals[:, None]
        P = fill_spline_segments(P, s_anchor)
        pred = _cv_prediction(obs, obs_vel, stage_t)
        P[:, :, ox_cols] = pred[..., 0]
        P[:, :, oy_cols] = pred[..., 1]
        return P

    def inputs(x0, obs0, obs_vel, weight_values):
        if len(weight_values) != len(per_episode_weights):
            raise ValueError(
                f"expected {len(per_episode_weights)} per-episode weight "
                f"arrays ({per_episode_weights}), got {len(weight_values)}")
        return (dev(x0), dev(obs0), dev(obs_vel),
                [dev(v) for v in weight_values])

    def rollout(x0, obs0, obs_vel, *weight_values):
        x, obs, obs_vel, weight_values = inputs(x0, obs0, obs_vel,
                                                weight_values)
        B = x.shape[0]
        Z0 = torch.zeros((B, N + 1, nvar), dtype=dtype, device=device)
        Z0[:, :, nu:] = x[:, None, :]
        Z = Z0
        succ, dists, lats = [], [], []
        for _ in range(n_ticks):
            # Progress re-anchor: the closest point of the straight path
            s_anchor = torch.clamp(x[:, 0], 0.0, path_len)
            x = x.clone()
            x[:, i_s] = s_anchor
            P = fill_params(s_anchor, obs, obs_vel, weight_values)
            res = rollout.fleet_solve(P, x, Z)
            u = _first_control_or_brake(res.success, res.z, x, iv, nu, dt)
            x = dynamics(x, u)
            obs = obs + obs_vel * dt
            Z = _shift_forward(res.z, res.success, Z0)
            succ.append(res.success)
            dists.append(_min_obstacle_distance(obs, x))
            lats.append(torch.abs(x[:, 1]))  # the path runs along y = 0
        dists = torch.stack(dists)
        return ContouringRolloutMetrics(
            progress=torch.clamp(x[:, 0], 0.0, path_len),
            collided=torch.any(dists < collision_dist, dim=0),
            max_lateral=torch.amax(torch.stack(lats), dim=0),
            solve_success_rate=torch.mean(torch.stack(succ).to(dtype), dim=0),
            min_obstacle_dist=torch.amin(dists, dim=0),
            final_state=x)

    def first_tick_params(x0, obs0, obs_vel, *weight_values):
        x, obs, obs_vel, weight_values = inputs(x0, obs0, obs_vel,
                                                weight_values)
        return fill_params(torch.clamp(x[:, 0], 0.0, path_len), obs, obs_vel,
                           weight_values)

    rollout.fleet_solve, rollout.backend, rollout.config = (solve, backend,
                                                            config)
    rollout.first_tick_params = first_tick_params
    return rollout, ocp
