"""Closed-loop Monte-Carlo evaluation on the device.

Counterpart of the JAX package's ``parallel/rollout.py``: B closed-loop
episodes advance together, per tick obstacle prediction -> per-stage
parameter fill -> one batched SQP solve -> first-control application
through the model dynamics -> obstacle propagation -> collision and
progress bookkeeping. The tick loop is a Python loop of device work: it
reads nothing back between ticks, and the caller reads the metrics once
after the last tick. On a CUDA device the default backend is the fused
kernel, one launch per tick.

Ported so far: the shared tick machinery and :func:`make_contouring_rollout`
(BASELINE config 2: the contouring model with ellipsoidal obstacles along a
straight reference path), with :func:`contouring_scenes`, the scene
sampler of the JAX package's ``tools/bench_rollout.py``. Its CC-MPC flavour
(``constraints="gaussian"``) needs the Gaussian constraint module, which
the port does not have yet (ROADMAP Queue A, item 4b).
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
                            constraints: str = "ellipsoid", *,
                            device="cuda"):
    """Closed-loop MPCC path following on ``device`` (BASELINE config 2: the
    contouring model and ellipsoidal obstacles along the straight path
    x(s) = s).

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

    ``constraints="gaussian"`` (the CC-MPC flavour, with the JAX
    package's ``risk`` and ``sigma_step``) raises ``NotImplementedError``:
    its module is not ported yet (ROADMAP 4b).
    """
    from ..models import ContouringSecondOrderUnicycleModel
    from ..modules import (ContouringModule, EllipsoidConstraintModule,
                           ModuleManager, MPCBaseModule)
    from ..solver import build_ocp
    from ..utils import default_settings

    if constraints not in ("ellipsoid", "gaussian"):
        raise ValueError(f"constraints must be 'ellipsoid' or 'gaussian', "
                         f"got {constraints!r}")
    if constraints == "gaussian":
        raise NotImplementedError(
            "constraints='gaussian' needs the Gaussian constraint module "
            "(CC-MPC), which the port does not have yet (ROADMAP Queue A, "
            "item 4b)")
    device = torch.device(device)
    settings = settings or default_settings(N=N, max_obstacles=n_obstacles)
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    base.weigh_variable("v", ["velocity", "reference_velocity"],
                        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    mm.add_module(ContouringModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
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
    _ellipsoid_statics(base_p, idx, n_obstacles, obstacle_radius)

    def dev(x, dt_=dtype):
        return torch.as_tensor(x, dtype=dt_, device=device)

    base_stage = dev(np.tile(base_p, (N, 1)))  # (N, npar)
    ox_cols = dev([idx[f"ellipsoid_obst_{i}_x"] for i in range(n_obstacles)],
                  torch.long)
    oy_cols = dev([idx[f"ellipsoid_obst_{i}_y"] for i in range(n_obstacles)],
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
