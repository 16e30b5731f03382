"""The plain reference of the contouring T-MPC++ OCPs, written out from the
formulation of the upstream ``mpc_planner`` stack (jackalsimulator settings):

- model: the second-order unicycle with a spline-progress state, z = (a, w,
  x, y, psi, v, s), dx/dt = (v cos psi, v sin psi, w, a, v), discretized by
  RK4 with 3 sub-steps over dt;
- cost (stage k < N): w_a a^2 + w_w w^2 + w_v (v - v_ref)^2 plus the
  contouring cost w_lag e_lag^2 + w_c e_c^2 against a path of sigmoid-blended
  cubic segments; the terminal cost (on x, at stage N with stage N-1's
  parameters) adds w_psi haar(psi - path angle)^2 and a terminal multiplier
  on the contouring terms; with ``consistency`` the stage cost adds
  w_cons |p - p_prev|^2;
- constraints (stages 0..N-1): with ``topology``, one halfspace a1 x + a2 y
  <= b per obstacle; one disc-ellipsoid row per obstacle, >= 1; box bounds
  on z (inputs at 0..N-1, states at 1..N-1).

Parameters are named; the layout is this module's own
(:func:`parameter_names`), and inputs in another layout are mapped by name.
Plain PyTorch, no code of the measured program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INF_BOUND = 1e15

#: z = (a, w, x, y, psi, v, s)
INPUTS = ("a", "w")
STATES = ("x", "y", "psi", "v", "spline")
NU, NX = 2, 5
NZ = NU + NX
LOWER = (-2.0, -0.8, -2000.0, -2000.0, -4 * math.pi, -0.01, -1.0)
UPPER = (2.0, 0.8, 2000.0, 2000.0, 4 * math.pi, 3.0, 10000.0)


def var(name):
    """Index of a variable in z."""
    return INPUTS.index(name) if name in INPUTS else NU + STATES.index(name)


def parameter_names(n_obstacles, num_segments, consistency, topology):
    """Every parameter of the OCP, in this reference's order."""
    names = ["acceleration", "angular_velocity", "velocity",
             "reference_velocity", "contour", "lag", "terminal_angle",
             "terminal_contouring"]
    for i in range(num_segments):
        names += [f"spline_{c}{i}_{k}" for c in "xy" for k in "abcd"]
        names.append(f"spline{i}_start")
    if consistency:
        names += ["consistency_weight", "prev_traj_x", "prev_traj_y"]
    if topology:
        for i in range(n_obstacles):
            names += [f"lin_constraint_{i}_{k}" for k in ("a1", "a2", "b")]
    names += ["ego_disc_radius", "ego_disc_0_offset"]
    for i in range(n_obstacles):
        names += [f"ellipsoid_obst_{i}_{k}"
                  for k in ("x", "y", "psi", "major", "minor", "chi", "r")]
    return names


class Ocp(NamedTuple):
    """One OCP: sizes, the parameter index, and its stage functions."""

    N: int
    dt: float
    names: tuple
    index: dict
    n_obstacles: int
    topology: bool
    cost_stage: object  # (z (nz,), p (npar,)) -> scalar
    cost_terminal: object  # (x (nx,), p) -> scalar
    ineq: object  # (z, p) -> (nh,)
    dynamics: object  # (x, u) -> x_next
    lh: np.ndarray
    uh: np.ndarray

    @property
    def npar(self):
        return len(self.names)


def build(cfg) -> Ocp:
    """The OCP of a configuration file's ``reference`` block: ``N``,
    ``dt``, ``n_obstacles``, ``num_segments``, ``consistency``,
    ``topology``."""
    N, dt = int(cfg["N"]), float(cfg["dt"])
    n_obs, n_seg = int(cfg["n_obstacles"]), int(cfg["num_segments"])
    consistency, topology = bool(cfg["consistency"]), bool(cfg["topology"])
    names = tuple(parameter_names(n_obs, n_seg, consistency, topology))
    index = {n: i for i, n in enumerate(names)}

    def get(p, name):
        return p[index[name]]

    def spline(p, c, s):
        """(value, derivative) of the blended spline c ('x' or 'y') at s."""
        starts = [get(p, f"spline{i}_start") for i in range(n_seg)]
        vals, ders = [], []
        for i in range(n_seg):
            a, b, cc, d = (get(p, f"spline_{c}{i}_{k}") for k in "abcd")
            ds = s - starts[i]
            vals.append(((a * ds + b) * ds + cc) * ds + d)
            ders.append((3.0 * a * ds + 2.0 * b) * ds + cc)
        val, der = vals[-1], ders[-1]
        for i in range(n_seg - 1, 0, -1):
            lam = torch.sigmoid(-(s - starts[i] + 0.02) / 0.1)
            val = lam * vals[i - 1] + (1.0 - lam) * val
            der = lam * ders[i - 1] + (1.0 - lam) * der
        return val, der

    def objective(z, p, terminal):
        a, w = z[var("a")], z[var("w")]
        x, y, psi = z[var("x")], z[var("y")], z[var("psi")]
        v, s = z[var("v")], z[var("spline")]
        cost = (get(p, "acceleration") * a ** 2
                + get(p, "angular_velocity") * w ** 2
                + get(p, "velocity") * (v - get(p, "reference_velocity")) ** 2)
        px, dx = spline(p, "x", s)
        py, dy = spline(p, "y", s)
        norm = torch.sqrt(dx * dx + dy * dy)
        dxn, dyn = dx / norm, dy / norm
        e_c = dyn * (x - px) - dxn * (y - py)
        e_l = dxn * (x - px) + dyn * (y - py)
        w_c, w_l = get(p, "contour"), get(p, "lag")
        cost = cost + w_l * e_l ** 2 + w_c * e_c ** 2
        if terminal:
            pi = torch.full((), math.pi, dtype=z.dtype, device=z.device)
            err = torch.fmod(psi - torch.atan2(dyn, dxn) + pi, 2.0 * pi) - pi
            m = get(p, "terminal_contouring")
            cost = (cost + get(p, "terminal_angle") * err ** 2
                    + m * w_l * e_l ** 2 + m * w_c * e_c ** 2)
        if consistency:
            cost = cost + get(p, "consistency_weight") * (
                (x - get(p, "prev_traj_x")) ** 2
                + (y - get(p, "prev_traj_y")) ** 2)
        return cost

    def cost_stage(z, p):
        return objective(z, p, terminal=False)

    def cost_terminal(xs, p):
        z = torch.cat([torch.zeros(NU, dtype=xs.dtype, device=xs.device), xs])
        return objective(z, p, terminal=True)

    def ineq(z, p):
        x, y, psi = z[var("x")], z[var("y")], z[var("psi")]
        rows = []
        if topology:
            for i in range(n_obs):
                rows.append(get(p, f"lin_constraint_{i}_a1") * x
                            + get(p, f"lin_constraint_{i}_a2") * y
                            - get(p, f"lin_constraint_{i}_b"))
        r_disc = get(p, "ego_disc_radius")
        off = get(p, "ego_disc_0_offset")
        ex, ey = x + torch.cos(psi) * off, y + torch.sin(psi) * off
        for i in range(n_obs):
            o = {k: get(p, f"ellipsoid_obst_{i}_{k}")
                 for k in ("x", "y", "psi", "major", "minor", "chi", "r")}
            major = o["major"] * torch.sqrt(o["chi"])
            minor = o["minor"] * torch.sqrt(o["chi"])
            a11 = 1.0 / ((major + r_disc + o["r"]) ** 2)
            a22 = 1.0 / ((minor + r_disc + o["r"]) ** 2)
            c, s = torch.cos(o["psi"]), torch.sin(o["psi"])
            e11 = a11 * c * c + a22 * s * s
            e22 = a11 * s * s + a22 * c * c
            e12 = (a22 - a11) * c * s
            dx, dy = ex - o["x"], ey - o["y"]
            rows.append(e11 * dx * dx + 2.0 * e12 * dx * dy + e22 * dy * dy)
        return torch.stack(rows)

    def continuous(xs, u):
        psi, v = xs[2], xs[3]
        return torch.stack([v * torch.cos(psi), v * torch.sin(psi), u[1],
                            u[0], v])

    def dynamics(xs, u):
        h = dt / 3
        for _ in range(3):
            k1 = continuous(xs, u)
            k2 = continuous(xs + 0.5 * h * k1, u)
            k3 = continuous(xs + 0.5 * h * k2, u)
            k4 = continuous(xs + h * k3, u)
            xs = xs + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return xs

    n_topo = n_obs if topology else 0
    lh = np.array([-INF_BOUND] * n_topo + [1.0] * n_obs)
    uh = np.array([0.0] * n_topo + [INF_BOUND] * n_obs)
    return Ocp(N, dt, names, index, n_obs, topology, cost_stage,
               cost_terminal, ineq, dynamics, lh, uh)


def row_spec(ocp: Ocp):
    """One-sided rows per stage: h lower rows, h upper rows, z lower box
    rows, z upper box rows (finite bounds only)."""
    rows = [("hl", i) for i in range(len(ocp.lh)) if ocp.lh[i] > -INF_BOUND]
    rows += [("hu", i) for i in range(len(ocp.uh)) if ocp.uh[i] < INF_BOUND]
    rows += [("zl", j) for j in range(NZ) if LOWER[j] > -INF_BOUND]
    rows += [("zu", j) for j in range(NZ) if UPPER[j] < INF_BOUND]
    return rows


def stage_mask(ocp: Ocp) -> np.ndarray:
    """(N+1, m): stage N unconstrained, no state box rows at stage 0."""
    spec = row_spec(ocp)
    mask = np.ones((ocp.N + 1, len(spec)))
    mask[ocp.N] = 0.0
    mask[0, [r for r, (k, i) in enumerate(spec)
             if k in ("zl", "zu") and i >= NU]] = 0.0
    return mask


def row_meta(ocp: Ocp):
    """The rows as the kernel B1 tags them: box rows by column and sign,
    generic rows dense."""
    return tuple(("box", i, 1.0) if k == "zl" else ("box", i, -1.0)
                 if k == "zu" else ("h", 0) for k, i in row_spec(ocp))
