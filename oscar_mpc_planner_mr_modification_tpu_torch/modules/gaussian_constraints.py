"""CC-MPC Gaussian chance constraints, torch counterpart of the JAX package's
``modules/gaussian_constraints.py``.

Per obstacle x mode x disc, the linear chance constraint
``a^T (p - mu) - (r_ego + r_obs) - erfinv(1 - 2 risk) sqrt(2 a^T Sigma a)
>= 0`` with ``a = (p - mu) / |p - mu|`` and ``Sigma = diag(sigma_x^2,
sigma_y^2)``, the inverse error function by :func:`..utils.math.erfinv_newton`.
Runtime: prediction step k-1 maps to stage k, with far-away dummies at k=0;
static obstacles get sigma = 0.001, and every sigma is floored at 1e-3 (a
zero sigma makes the row's Jacobian NaN through d sqrt(u)/du at u = 0).
Mode 0 keeps the reference parameter names and modes ``j >= 1`` use the
``_m{j}`` suffix, with the risk split over modes by
:func:`.base.mode_risk_allocation`; an absent mode is a far dummy with sigma
1e-3 and risk 0.49.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ConstraintModule, ego_disc_position, mode_risk_allocation
from ..types import ObstacleType, PredictionType, mode_positions
from ..utils.math import erfinv_newton


def _is(value, member) -> bool:
    """Enum membership by name, so that predictions and obstacles built with
    another package's enums are read alike."""
    return value.name == member.name


class GaussianConstraintModule(ConstraintModule):
    module_name = "GaussianConstraints"
    description = "CC-MPC linearized Gaussian chance constraints"

    def __init__(self, settings):
        self.settings = settings
        self.n_discs = settings["n_discs"]
        self.max_obstacles = settings["max_obstacles"]
        self.max_modes = int(settings["probabilistic"].get("max_modes", 1))
        self.nh = self.max_obstacles * self.max_modes * self.n_discs
        self.risk = settings["probabilistic"]["risk"]
        self.robot_radius = settings["robot_radius"]
        self._dummy = np.zeros(2)

    def _p(self, i: int, j: int, name: str) -> str:
        """Parameter name for obstacle i, mode j (mode 0 = reference names)."""
        return (f"gaussian_obst_{i}_{name}" if j == 0
                else f"gaussian_obst_{i}_m{j}_{name}")

    # -- symbolic ----------------------------------------------------------
    def define_parameters(self, params) -> None:
        params.add("ego_disc_radius")
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
        for i in range(self.max_obstacles):
            for j in range(self.max_modes):
                suffix = "" if j == 0 else f"_m{j}"
                for name in ("x", "y", "major", "minor", "risk"):
                    params.add(self._p(i, j, name),
                               bundle_name=f"gaussian_obst{suffix}_{name}")
            params.add(f"gaussian_obst_{i}_r", bundle_name="gaussian_obst_r")

    def get_lower_bound(self):
        return [0.0] * self.nh

    def get_upper_bound(self):
        return [np.inf] * self.nh

    def get_constraints(self, model, params, settings, stage_idx):
        constraints = []
        r_vehicle = params.get("ego_disc_radius")

        for i in range(self.max_obstacles):
            r_obstacle = params.get(f"gaussian_obst_{i}_r")
            combined_radius = r_vehicle + r_obstacle
            for j in range(self.max_modes):
                obs_x = params.get(self._p(i, j, "x"))
                obs_y = params.get(self._p(i, j, "y"))
                sigma_x = params.get(self._p(i, j, "major"))
                sigma_y = params.get(self._p(i, j, "minor"))
                risk = params.get(self._p(i, j, "risk"))

                for d in range(self.n_discs):
                    px, py = ego_disc_position(model, params, d)
                    dx = px - obs_x
                    dy = py - obs_y
                    dist = torch.sqrt(dx * dx + dy * dy)
                    ax = dx / dist
                    ay = dy / dist
                    y_erfinv = erfinv_newton(1.0 - 2.0 * risk)
                    # a^T Sigma a with Sigma = diag(sigma_x^2, sigma_y^2)
                    a_sigma_a = ax * ax * sigma_x**2 + ay * ay * sigma_y**2
                    # 2 as a tensor of the row's dtype: a Python float times
                    # a 0-d f32 tensor gives f64 derivatives under jacfwd
                    two = torch.full((), 2.0, dtype=a_sigma_a.dtype,
                                     device=a_sigma_a.device)
                    constraints.append(
                        ax * dx + ay * dy - combined_radius
                        - y_erfinv * torch.sqrt(two * a_sigma_a))

        return constraints

    # -- runtime -----------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        self._dummy = np.array([state.get("x") + 50.0, state.get("y") + 50.0])

    def set_parameters(self, buf, data, module_data) -> None:
        buf.set("ego_disc_radius", self.robot_radius)
        for d in range(self.n_discs):
            buf.set(f"ego_disc_{d}_offset", data.robot_area[d].offset)

        N = buf.N
        for i, obstacle in enumerate(data.dynamic_obstacles[: self.max_obstacles]):
            buf.set(f"gaussian_obst_{i}_r", obstacle.radius)
            risks = mode_risk_allocation(obstacle.prediction, self.risk,
                                         self.max_modes)
            for j in range(self.max_modes):
                if j >= len(obstacle.prediction.modes):
                    buf.set(self._p(i, j, "x"), self._dummy[0])
                    buf.set(self._p(i, j, "y"), self._dummy[1])
                    buf.set(self._p(i, j, "major"), 1e-3)
                    buf.set(self._p(i, j, "minor"), 1e-3)
                    buf.set(self._p(i, j, "risk"), 0.49)
                    continue
                mode = obstacle.prediction.modes[j]
                n = min(N - 1, len(mode))
                col_x = np.full(N, self._dummy[0])
                col_y = np.full(N, self._dummy[1])
                mp = mode_positions(mode)
                col_x[1 : 1 + n] = mp[:n, 0]
                col_y[1 : 1 + n] = mp[:n, 1]
                buf.set(self._p(i, j, "x"), col_x)
                buf.set(self._p(i, j, "y"), col_y)
                if _is(obstacle.type, ObstacleType.STATIC):
                    sig_major = np.full(N, 0.001)
                    sig_minor = np.full(N, 0.001)
                else:
                    sig_major = np.zeros(N)
                    sig_minor = np.zeros(N)
                    sig_major[1 : 1 + n] = [s.major_radius for s in mode[:n]]
                    sig_minor[1 : 1 + n] = [s.minor_radius for s in mode[:n]]
                buf.set(self._p(i, j, "major"), np.maximum(sig_major, 1e-3))
                buf.set(self._p(i, j, "minor"), np.maximum(sig_minor, 1e-3))
                buf.set(self._p(i, j, "risk"), risks[j])

    def is_data_ready(self, data) -> bool:
        if len(data.robot_area) == 0:
            return False
        if len(data.dynamic_obstacles) != self.max_obstacles:
            return False
        return all(not obs.prediction.empty()
                   and _is(obs.prediction.type, PredictionType.GAUSSIAN)
                   for obs in data.dynamic_obstacles)

    def missing_data(self, data) -> str:
        return "" if self.is_data_ready(data) else "Obstacles (Gaussian) "
