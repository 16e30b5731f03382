"""Benchmark scenario builders (numpy), counterpart of the JAX package's
``benchmarks.py`` against this package's registry.

The flagship workload is the T-MPC++ configuration (contouring + consistency +
guidance/ellipsoid constraints) at N=20 with 8 guidance trajectories + 1
unguided planner per plan instance. ``build_tmpc_fleet`` produces the stacked
(B, P, ...) arrays for :func:`.parallel.batch.make_batched_tmpc_step`:
per-instance obstacle layouts, straight-line reference spline parameters,
homotopy-distinct guidance warmstarts (lateral-offset bundles around the
obstacles) and the matching single-disc topology halfspaces. For the same seed
it gives the same arrays as the JAX package's builder. With
``dynamic_velocity_reference`` the OCP tracks the PathReferenceVelocity
module's spline instead of a constant reference velocity, and the fleet's
velocity reference falls linearly along the path (:data:`VREF_RAMP`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .factory import configuration_tmpc_consistency_cost
from .solver.ocp import build_ocp
from .utils.config import default_settings


#: The dynamic velocity reference of the fleet, v_ref(s) = v0 + slope s:
#: 2.0 m/s at the start of the path, 0.5 m/s after its 25 m.
VREF_RAMP = (2.0, -0.06)


def tmpc_bench_ocp(N: int = 20, n_paths: int = 8, max_obstacles: int = 4,
                   dynamic_velocity_reference: bool = False):
    settings = default_settings(
        N=N, max_obstacles=max_obstacles,
        guidance={"n_paths": n_paths},
        JULES={"n_paths": n_paths},
        contouring={"dynamic_velocity_reference": dynamic_velocity_reference},
    )
    model, modules = configuration_tmpc_consistency_cost(settings)
    ocp = build_ocp(model, modules, settings)
    return ocp, settings


def build_tmpc_fleet(ocp, settings, batch: int, seed: int = 0,
                     dtype=np.float32) -> Tuple[np.ndarray, ...]:
    """Stacked fleet inputs: params (B,P,N,npar), xinit (B,nx),
    z_init (B,P,N+1,nvar), disabled (B,P)."""
    rng = np.random.default_rng(seed)
    N = ocp.N
    n_paths = int(settings["guidance"]["n_paths"])
    P = n_paths + 1
    n_obs = int(settings["max_obstacles"])
    reg = ocp.registry
    idx = reg.save_map()
    npar = ocp.npar
    nvar, nu, nx = ocp.nvar, ocp.nu, ocp.nx
    robot_radius = float(settings["robot_radius"])

    base = np.zeros(npar, dtype=np.float64)
    w = settings["weights"]
    base[idx["acceleration"]] = w["acceleration"]
    base[idx["angular_velocity"]] = w["angular_velocity"]
    base[idx["velocity"]] = w["velocity"]
    base[idx["reference_velocity"]] = w["reference_velocity"]
    base[idx["contour"]] = w["contour"]
    base[idx["lag"]] = w["lag"]
    base[idx["terminal_angle"]] = w["terminal_angle"]
    base[idx["terminal_contouring"]] = w["terminal_contouring"]
    # Straight-line reference path x(s) = s, 5 segments of 5 m
    for i in range(settings["contouring"]["num_segments"]):
        base[idx[f"spline_x{i}_c"]] = 1.0
        base[idx[f"spline{i}_start"]] = 5.0 * i
        if f"spline_v{i}_d" in idx:  # local cubic of the ramp on segment i
            base[idx[f"spline_v{i}_c"]] = VREF_RAMP[1]
            base[idx[f"spline_v{i}_d"]] = VREF_RAMP[0] + VREF_RAMP[1] * 5.0 * i
    base[idx["ego_disc_radius"]] = robot_radius
    base[idx["ego_disc_0_offset"]] = 0.0
    # Inactive topology halfspaces (overridden per guided planner below); a zero
    # row would be a degenerate always-active constraint for the IP solver
    base[np.asarray(reg.bundle_indices("lin_constraint_a1"))] = 1.0
    base[np.asarray(reg.bundle_indices("lin_constraint_b"))] = 1.0e4

    params = np.tile(base, (batch, P, N, 1))
    xinit = np.zeros((batch, nx))
    z_init = np.zeros((batch, P, N + 1, nvar))
    disabled = np.zeros((batch, P), dtype=bool)

    ix = ocp.model.var_index("x")
    iy = ocp.model.var_index("y")
    ipsi = ocp.model.var_index("psi")
    iv = ocp.model.var_index("v")
    ispline = ocp.model.var_index("spline")

    v0 = 1.5
    dt = ocp.dt
    t_grid = np.arange(N + 1) * dt

    for b in range(batch):
        # Instance-specific obstacles ahead of the robot
        obs_pos = np.stack([
            rng.uniform(2.0, 7.0, n_obs), rng.uniform(-1.5, 1.5, n_obs)], axis=1)
        obs_vel = rng.uniform(-0.5, 0.5, (n_obs, 2))
        xinit[b] = np.array([0.0, 0.0, 0.0, v0, 0.0])
        for o in range(n_obs):
            # One stage-time convention for all constraint families: stage k
            # reads the obstacle at k*dt (k=0 is a dummy below), matching the
            # topology halfspaces.
            traj = (obs_pos[o][None]
                    + obs_vel[o][None] * t_grid[:N, None])  # (N, 2)
            params[b, :, :, idx[f"ellipsoid_obst_{o}_x"]] = traj[:, 0]
            params[b, :, :, idx[f"ellipsoid_obst_{o}_y"]] = traj[:, 1]
            params[b, :, 0, idx[f"ellipsoid_obst_{o}_x"]] = 50.0  # k=0 dummy
            params[b, :, 0, idx[f"ellipsoid_obst_{o}_y"]] = 50.0
            params[b, :, :, idx[f"ellipsoid_obst_{o}_r"]] = 0.3
            params[b, :, :, idx[f"ellipsoid_obst_{o}_chi"]] = 1.0

        # Homotopy-distinct guidance warmstarts: lateral-offset bundles
        for p in range(P):
            if p < n_paths:
                lateral = ((-1) ** p) * (0.4 + 0.4 * (p // 2))
                envelope = np.sin(np.linspace(0, np.pi, N + 1))
                ys = lateral * envelope
            else:
                ys = np.zeros(N + 1)  # unguided planner: straight warmstart
            xs = v0 * t_grid
            z_init[b, p, :, ix] = xs
            z_init[b, p, :, iy] = ys
            dx = np.gradient(xs, dt)
            dy = np.gradient(ys, dt)
            z_init[b, p, :, ipsi] = np.arctan2(dy, dx)
            z_init[b, p, :, iv] = np.hypot(dx, dy)
            z_init[b, p, :, ispline] = xs
            # Topology halfspaces linearized around this warmstart (k=1..N-1)
            if p < n_paths:
                a1 = reg.bundle_indices("lin_constraint_a1")
                a2 = reg.bundle_indices("lin_constraint_a2")
                bb = reg.bundle_indices("lin_constraint_b")
                radius = 1e-3 + robot_radius
                for k in range(1, N):
                    pos = np.array([xs[k], ys[k]])
                    for o in range(min(n_obs, len(a1))):
                        # centers at k*dt: same convention as the ellipsoid
                        # rows above
                        c = obs_pos[o] + obs_vel[o] * k * dt
                        diff = c - pos
                        dist = np.linalg.norm(diff)
                        if dist < radius + 1e-6:
                            continue
                        a = diff / dist
                        params[b, p, k, a1[o]] = a[0]
                        params[b, p, k, a2[o]] = a[1]
                        params[b, p, k, bb[o]] = a @ c - radius
    # Default inactive topology rows for unguided / k=0
    return (params.astype(dtype), xinit.astype(dtype), z_init.astype(dtype),
            disabled)
