"""A fleet of robots' T-MPC++ problems, made from a seed: every robot on a
straight path x(s) = s from rest at 1.5 m/s with its own obstacles ahead
(positions and velocities drawn uniformly), its guided planners warm-started
on lateral-offset bundles (alternating sides, 0.4 m steps) with the
halfspaces of each obstacle linearized around them, and one unguided
planner on the straight line. The parameters are named as in
:func:`..reference.ocp.parameter_names`. Plain numpy."""

from __future__ import annotations

import numpy as np

from ..reference import ocp as ocp_mod


def build(ocp, cfg, batch, seed):
    """(params (B, P, N, npar), xinit (B, nx), z_init (B, P, N+1, nz)) in
    float64; P = n_paths + 1. ``seed`` is anything numpy seeds a generator
    with."""
    rng = np.random.default_rng(seed)
    N, dt = ocp.N, ocp.dt
    n_paths = int(cfg["n_paths"])
    P = n_paths + 1
    n_obs = ocp.n_obstacles
    idx = ocp.index
    w = cfg["weights"]
    radius_robot = float(cfg["robot_radius"])

    base = np.zeros(ocp.npar)
    for name in ("acceleration", "angular_velocity", "velocity",
                 "reference_velocity", "contour", "lag", "terminal_angle",
                 "terminal_contouring"):
        base[idx[name]] = w[name]
    for i in range(int(cfg["num_segments"])):
        base[idx[f"spline_x{i}_c"]] = 1.0
        base[idx[f"spline{i}_start"]] = 5.0 * i
    base[idx["ego_disc_radius"]] = radius_robot
    a1 = [idx[f"lin_constraint_{i}_a1"] for i in range(n_obs)]
    a2 = [idx[f"lin_constraint_{i}_a2"] for i in range(n_obs)]
    bb = [idx[f"lin_constraint_{i}_b"] for i in range(n_obs)]
    base[a1] = 1.0
    base[bb] = 1.0e4

    params = np.tile(base, (batch, P, N, 1))
    xinit = np.zeros((batch, ocp_mod.NX))
    z_init = np.zeros((batch, P, N + 1, ocp_mod.NZ))
    ix, iy, ipsi, iv, isp = (ocp_mod.var(n) for n in
                             ("x", "y", "psi", "v", "spline"))
    v0 = 1.5
    t_grid = np.arange(N + 1) * dt
    radius = 1e-3 + radius_robot
    draws = [(rng.uniform(2.0, 7.0, n_obs), rng.uniform(-1.5, 1.5, n_obs),
              rng.uniform(-0.5, 0.5, (n_obs, 2))) for _ in range(batch)]
    obs_pos = np.stack([np.stack([x, y], axis=1) for x, y, _ in draws])
    obs_vel = np.stack([v for _, _, v in draws])  # (B, n_obs, 2)
    xinit[:] = [0.0, 0.0, 0.0, v0, 0.0]
    # obstacle o at stage k: position + velocity k dt; stage 0 a far dummy
    traj = obs_pos[:, :, None] + obs_vel[:, :, None] * t_grid[None, None, :N,
                                                             None]
    for o in range(n_obs):
        for c, col in (("x", 0), ("y", 1)):
            params[:, :, :, idx[f"ellipsoid_obst_{o}_{c}"]] = \
                traj[:, None, o, :, col]
            params[:, :, 0, idx[f"ellipsoid_obst_{o}_{c}"]] = 50.0
        params[:, :, :, idx[f"ellipsoid_obst_{o}_r"]] = 0.3
        params[:, :, :, idx[f"ellipsoid_obst_{o}_chi"]] = 1.0
    xs = v0 * t_grid
    for p in range(P):
        if p < n_paths:
            lateral = ((-1) ** p) * (0.4 + 0.4 * (p // 2))
            ys = lateral * np.sin(np.linspace(0, np.pi, N + 1))
        else:
            ys = np.zeros(N + 1)
        dx, dy = np.gradient(xs, dt), np.gradient(ys, dt)
        z_init[:, p, :, ix] = xs
        z_init[:, p, :, iy] = ys
        z_init[:, p, :, ipsi] = np.arctan2(dy, dx)
        z_init[:, p, :, iv] = np.hypot(dx, dy)
        z_init[:, p, :, isp] = xs
        if p >= n_paths:
            continue
        # halfspaces around this warm start at stages 1..N-1
        k = np.arange(1, N)
        pos = np.stack([xs[k], ys[k]], axis=1)  # (N-1, 2)
        c = obs_pos[:, :, None] + obs_vel[:, :, None] * (k * dt)[None, None, :,
                                                                 None]
        diff = c - pos[None, None]  # (B, n_obs, N-1, 2)
        dist = np.linalg.norm(diff, axis=-1)
        keep = ~(dist < radius + 1e-6)
        a = diff / np.where(keep, dist, 1.0)[..., None]
        b_val = np.sum(a * c, axis=-1) - radius
        for o in range(n_obs):
            for col, val in ((a1[o], a[:, o, :, 0]), (a2[o], a[:, o, :, 1]),
                             (bb[o], b_val[:, o])):
                cur = params[:, p, 1:, col]
                params[:, p, 1:, col] = np.where(keep[:, o], val, cur)
    return params, xinit, z_init
