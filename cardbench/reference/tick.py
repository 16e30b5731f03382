"""What one planner tick must have done, worked out again from the scene:
the OCP parameters of every planner, the initial state and warm starts,
the cost of each returned trajectory, the fair-cost selection and the
command. Every function reads the scene (robot state, pedestrian
observations, clock) and the tick's record; a planner's guidance
trajectory, the one input the scene does not fix, is taken from the
program's warm start of that planner (the guidance search is not
repeated). Plain numpy and :mod:`.sqp`; no code of the measured program."""

from __future__ import annotations

import numpy as np

from . import ocp as ocp_mod

IX, IY, IPSI, IV, IS = (ocp_mod.var(n) for n in ("x", "y", "psi", "v",
                                                  "spline"))
IA, IW = ocp_mod.var("a"), ocp_mod.var("w")


def nearest_obstacles(state, pos, vel, k, N, dt):
    """Indices of the k pedestrians nearest to the robot's straight-line
    prediction (distance at each step scaled by (step + 1) * 0.6, the least
    over the horizon), nearest first, and each pedestrian's constant-velocity
    prediction (n, N, 2)."""
    steps = np.arange(N, dtype=float)
    pred = pos[:, None, :] + dt * steps[None, :, None] * vel[:, None, :]
    if len(pos) <= k:
        return np.arange(len(pos)), pred
    direction = np.array([np.cos(state[2]), np.sin(state[2])])
    ego = state[:2][None, :] + np.outer(state[3] * steps, direction)
    d = (steps + 1.0)[None] * 0.6 * np.linalg.norm(pred - ego[None], axis=2)
    return np.argsort(d.min(axis=1))[:k], pred


def expected_columns(cfg, ocp, state, obs):
    """{parameter: (N,) values} that every planner shares: the weights, the
    ego disc and the obstacles. ``obs`` is ``(pos, vel, radius)``."""
    N, dt = ocp.N, float(cfg["obstacle_dt"])
    w = cfg["weights"]
    col = {name: np.full(N, float(w[name])) for name in
           ("acceleration", "angular_velocity", "velocity",
            "reference_velocity", "contour", "lag", "terminal_angle",
            "terminal_contouring")}
    col["ego_disc_radius"] = np.full(N, float(cfg["robot_radius"]))
    col["ego_disc_0_offset"] = np.zeros(N)
    pos, vel, radius = obs
    order, pred = nearest_obstacles(state, pos, vel, ocp.n_obstacles, N, dt)
    dummy = state[:2] + 50.0
    for i, j in enumerate(order):
        x = np.full(N, dummy[0])
        y = np.full(N, dummy[1])
        x[1:] = pred[j, :N - 1, 0]
        y[1:] = pred[j, :N - 1, 1]
        r = np.full(N, float(radius))
        r[0] = 0.1
        col.update({f"ellipsoid_obst_{i}_x": x, f"ellipsoid_obst_{i}_y": y,
                    f"ellipsoid_obst_{i}_psi": np.zeros(N),
                    f"ellipsoid_obst_{i}_major": np.zeros(N),
                    f"ellipsoid_obst_{i}_minor": np.zeros(N),
                    f"ellipsoid_obst_{i}_chi": np.ones(N),
                    f"ellipsoid_obst_{i}_r": r})
    centers = np.stack([pred[j] for j in order], axis=1)  # (N, k, 2)
    return col, centers


def topology_rows(warm, centers, robot_radius, n_rows):
    """(a1, a2, b) each (N, n_rows) of the halfspaces around one planner's
    warm start: its positions at stages 1..N-1 pushed out of every obstacle
    disc (three sweeps, one obstacle after the other), then each row's
    normal towards the obstacle's centre; stage 0 and absent rows inactive
    (1, 0, 1e4)."""
    N = centers.shape[0]
    a1, a2, b = np.ones((N, n_rows)), np.zeros((N, n_rows)), np.full(
        (N, n_rows), 1.0e4)
    n_obs = centers.shape[1]
    if n_obs == 0:
        return a1, a2, b
    radius = 1e-3 + robot_radius
    c_k = centers[:N - 1]  # stage k reads prediction step k-1
    pos = warm[1:N][:, [IX, IY]].copy()
    for _ in range(3):
        for i in range(n_obs):
            c = c_k[:, i]
            d = pos - c
            dist = np.linalg.norm(d, axis=-1, keepdims=True)
            degenerate = dist < 1e-9
            proj = c + d * (radius / np.maximum(dist, 1e-30))
            pos = np.where((dist < radius) & ~degenerate, proj, pos)
            pos = np.where(degenerate, c + np.array([radius, 0.0]), pos)
    n_fill = min(n_obs, n_rows)
    cc = c_k[:, :n_fill]
    diff = cc - pos[:, None]
    dist = np.linalg.norm(diff, axis=-1)
    ok = dist >= 1e-9
    a = diff / np.maximum(dist, 1e-30)[..., None]
    bb = np.sum(a * cc, axis=-1) - radius
    a1[1:, :n_fill] = np.where(ok, a[..., 0], 1.0)
    a2[1:, :n_fill] = np.where(ok, a[..., 1], 0.0)
    b[1:, :n_fill] = np.where(ok, bb, 1.0e4)
    return a1, a2, b


def braking(state, N, dt, decel):
    """The warm start after an infeasible tick: decelerate along the
    heading until stopped. (N+1, nz)."""
    out = np.zeros((N + 1, ocp_mod.NZ))
    out[:, ocp_mod.NU:] = state[None, :]
    x, y, psi, v, s = (float(state[i]) for i in range(5))
    a = -abs(float(decel))

    def put(k, x, y, v, s):
        out[k, [IX, IY, IPSI, IV, IS, IA, IW]] = x, y, psi, v, s, a, 0.0

    put(0, x, y, v, s)
    for k in range(1, N + 1):
        x += v * dt * np.cos(psi)
        y += v * dt * np.sin(psi)
        s += v * dt
        v = max(v + a * dt, 0.0)
        put(k, x, y, v, s)
    return out


def interpolate(prev, elapsed, dt):
    """The previous plan's positions (N, 2) shifted by the time elapsed;
    None where it has run out."""
    N = len(prev)
    k_shift = int(np.floor(elapsed / dt))
    alpha = (elapsed - k_shift * dt) / dt
    if k_shift >= N - 1:
        return None
    out = np.zeros_like(prev)
    for k in range(N):
        src = k + k_shift
        if src < N - 1:
            out[k] = (1 - alpha) * prev[src] + alpha * prev[src + 1]
        elif src == N - 1:
            out[k] = prev[N - 1]
        else:
            vel = (prev[N - 1] - prev[N - 2]) / dt
            out[k] = prev[N - 1] + vel * ((src - (N - 1)) * dt + alpha * dt)
    return out


def _gap(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    if got.shape != want.shape:
        return np.inf
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want)),
                        initial=0.0))


def fill_gap(cfg, ocp, rec, prev):
    """The largest relative gap between what the tick handed the solver
    (``rec``: params (P, N, npar) in the reference layout, xinit, warm
    (P, N+1, nz), n_guidance; the scene before it) and what the scene
    asks for; ``prev`` is the previous tick of the episode or None.
    Returns (gap, where)."""
    N, P = ocp.N, rec["params"].shape[0]
    n_paths = P - 1 if cfg["tmpc"] else 0
    state = rec["state"]
    cols, centers = expected_columns(cfg, ocp, state, rec["obs"])
    worst = (0.0, "")

    def note(gap, where):
        nonlocal worst
        if gap > worst[0] or not np.isfinite(gap):
            worst = (gap, where)

    ix = ocp.index
    prm = rec["params"]
    for p in range(P):
        for name, want in cols.items():
            note(_gap(prm[p, :, ix[name]], want), f"planner {p} {name}")
        x_s = np.arange(0.0, 1.0, 0.125)
        for i in range(int(cfg["num_segments"])):
            start = prm[p, :, ix[f"spline{i}_start"]]
            for c, want in (("x", start[:, None] + x_s), ("y", 0.0 * x_s)):
                a, b, cc, d = (prm[p, :, ix[f"spline_{c}{i}_{k}"]][:, None]
                               for k in "abcd")
                got = ((a * x_s + b) * x_s + cc) * x_s + d
                note(_gap(got, np.broadcast_to(want, got.shape)),
                     f"planner {p} spline {c}{i}")
    note(_gap(rec["xinit"], state), "xinit")
    note(_gap(rec["progress"], min(max(state[0], 0.0), cfg["path_length"])),
         "progress")

    succeeded = prev is not None and prev["success"]
    main_warm = (prev["z_best"] if succeeded else
                 braking(state, N, ocp.dt, cfg["deceleration_at_infeasible"]))
    disabled = [p >= rec["n_guidance"] and p < n_paths for p in range(P)]
    for p in range(P):
        w = rec["warm"][p]
        if p < n_paths and not disabled[p]:
            keep = [IA, IW, IS]
            note(_gap(w[:, keep], main_warm[:, keep]), f"planner {p} warm")
            note(_gap(w[[0, N]], main_warm[[0, N]]), f"planner {p} warm ends")
        else:
            note(_gap(w, main_warm), f"planner {p} warm")
    if not cfg["tmpc"]:
        return worst

    n_rows = ocp.n_obstacles
    for p in range(P):
        guided = p < n_paths and not disabled[p]
        if guided:
            a1, a2, b = topology_rows(rec["warm"][p], centers,
                                      float(cfg["robot_radius"]), n_rows)
        else:
            a1, a2, b = (np.ones((N, n_rows)), np.zeros((N, n_rows)),
                         np.full((N, n_rows), 1.0e4))
        for i in range(n_rows):
            for name, want in (("a1", a1[:, i]), ("a2", a2[:, i]),
                               ("b", b[:, i])):
                note(_gap(prm[p, :, ix[f"lin_constraint_{i}_{name}"]], want),
                     f"planner {p} lin_constraint_{i}_{name}")

    interp = None
    if succeeded:
        interp = interpolate(prev["z_best"][:N][:, [IX, IY]],
                             max(0.0, rec["clock"] - prev["clock"]), ocp.dt)
    w_c = float(cfg["weights"]["consistency"])
    for p in range(P):
        if disabled[p]:
            continue
        got = prm[p][:, [ix["consistency_weight"], ix["prev_traj_x"],
                         ix["prev_traj_y"]]]
        want = np.zeros_like(got)
        if got[1, 0] != 0.0:
            if interp is None:
                note(np.inf, f"planner {p} consistency without a previous plan")
                continue
            want[1:N - 1, 0] = w_c
            want[1:N - 1, 1:] = interp[1:N - 1]
        note(_gap(got, want), f"planner {p} consistency")
    return worst


def fair_costs(cfg, rec, prev, costs):
    """Each planner's cost less its realized consistency cost, where the
    planner had consistency on, as the selection compares them."""
    N = rec["params"].shape[1]
    out = np.array(costs, dtype=float)
    if not (cfg["tmpc"] and prev is not None and prev["success"]):
        return out
    interp = interpolate(prev["z_best"][:N][:, [IX, IY]],
                         max(0.0, rec["clock"] - prev["clock"]),
                         float(cfg["dt"]))
    if interp is None:
        return out
    w_c = float(cfg["weights"]["consistency"])
    iw = rec["consistency_col"]
    for p in range(len(out)):
        if rec["params"][p, 1, iw] != 0.0:
            diff = rec["z"][p, 1:N - 1][:, [IX, IY]] - interp[1:N - 1]
            out[p] -= w_c * float(np.sum(diff ** 2))
    return out


def selection_errors(cfg, rec, prev, cost_ref, success_ref, tol):
    """Faults of the tick's selection and command, as strings: a planner
    whose success the reference's defect check does not confirm; a compared
    cost that is neither the fair cost nor, for a guided planner, the fair
    cost times the consistency weight of a previously selected topology
    (within ``tol`` relative); a
    winner that is not the first feasible planner of least compared cost;
    a command that is not the winner's first control."""
    errs = []
    P = len(rec["success"])
    n_paths = P - 1 if cfg["tmpc"] else 0
    disabled = np.array([n_paths > p >= rec["n_guidance"] for p in range(P)])
    for p in range(P):
        if bool(rec["success"][p]) != bool(success_ref[p]):
            errs.append(f"planner {p} success {rec['success'][p]} vs "
                        f"{success_ref[p]}")
    feasible = np.where(np.asarray(rec["success"]) & ~disabled)[0]
    best = rec["best"]
    if cfg["tmpc"]:
        fair = fair_costs(cfg, rec, prev, cost_ref)
        shown = np.asarray(rec["objectives"], dtype=float)
        sel_w = float(cfg["selection_weight_consistency"])
        for p in feasible:
            ok = [fair[p]] + ([fair[p] * sel_w] if p < n_paths else [])
            if min(abs(shown[p] - v) / (1.0 + abs(v)) for v in ok) > tol:
                errs.append(f"planner {p} compared cost {shown[p]} vs {ok}")
        want = int(feasible[np.argmin(shown[feasible])]) if len(feasible) \
            else -1
    else:
        want = 0 if len(feasible) else -1
    if best != want:
        errs.append(f"winner {best} vs {want}")
    if want >= 0 and best == want:
        z0 = rec["z"][best][0]
        if (rec["command"][0], rec["command"][1]) != (z0[IA], z0[IW]):
            errs.append(f"command {rec['command']} vs {(z0[IA], z0[IW])}")
        if not rec["out_success"]:
            errs.append("winner found but the tick reports failure")
    elif want < 0 and rec["out_success"]:
        errs.append("no feasible planner but the tick reports success")
    return errs
