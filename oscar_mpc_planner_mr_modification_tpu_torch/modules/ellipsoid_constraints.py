"""Ellipsoidal dynamic-obstacle avoidance constraints, torch counterpart of the
JAX package's ``modules/ellipsoid_constraints.py``.

Per obstacle x mode x disc: ``(p - c)^T R^T A R (p - c) >= 1`` with semi-axes
inflated by ``sqrt(chi)`` plus the combined radii. Runtime: prediction step k-1
maps to stage k, with far-away dummies at k=0; mode 0 keeps the reference
parameter names and modes ``j >= 1`` use the ``_m{j}`` suffix.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ConstraintModule, ego_disc_position, mode_risk_allocation
from ..types import PredictionType, mode_positions
from ..utils.math import exponential_quantile


def _kind(prediction) -> PredictionType:
    """The prediction's type as this package's enum (matched by name, so
    predictions built with another package's enum are read alike)."""
    return PredictionType[prediction.type.name]


class EllipsoidConstraintModule(ConstraintModule):
    module_name = "EllipsoidConstraints"
    description = "Avoid obstacles, modeled as ellipsoids (incl. Gaussian noise)."

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
        return (f"ellipsoid_obst_{i}_{name}" if j == 0
                else f"ellipsoid_obst_{i}_m{j}_{name}")

    # -- symbolic ----------------------------------------------------------
    def define_parameters(self, params) -> None:
        params.add("ego_disc_radius")
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
        for i in range(self.max_obstacles):
            for j in range(self.max_modes):
                suffix = "" if j == 0 else f"_m{j}"
                for name in ("x", "y", "psi", "major", "minor", "chi"):
                    params.add(self._p(i, j, name),
                               bundle_name=f"ellipsoid_obst{suffix}_{name}")
            params.add(f"ellipsoid_obst_{i}_r", bundle_name="ellipsoid_obst_r")

    def get_lower_bound(self):
        return [1.0] * self.nh

    def get_upper_bound(self):
        return [np.inf] * self.nh

    def get_constraints(self, model, params, settings, stage_idx):
        constraints = []
        r_disc = params.get("ego_disc_radius")

        for obs_id in range(self.max_obstacles):
            obst_r = params.get(f"ellipsoid_obst_{obs_id}_r")
            for j in range(self.max_modes):
                obst_x = params.get(self._p(obs_id, j, "x"))
                obst_y = params.get(self._p(obs_id, j, "y"))
                obst_psi = params.get(self._p(obs_id, j, "psi"))
                obst_major = params.get(self._p(obs_id, j, "major"))
                obst_minor = params.get(self._p(obs_id, j, "minor"))
                chi = params.get(self._p(obs_id, j, "chi"))

                major = obst_major * torch.sqrt(chi)
                minor = obst_minor * torch.sqrt(chi)
                a11 = 1.0 / ((major + r_disc + obst_r) ** 2)
                a22 = 1.0 / ((minor + r_disc + obst_r) ** 2)
                c, s = torch.cos(obst_psi), torch.sin(obst_psi)
                # R^T diag(a11, a22) R with R(psi) = [[c, -s], [s, c]]
                e11 = a11 * c * c + a22 * s * s
                e22 = a11 * s * s + a22 * c * c
                e12 = (a22 - a11) * c * s

                for d in range(self.n_discs):
                    px, py = ego_disc_position(model, params, d)
                    dx = px - obst_x
                    dy = py - obst_y
                    constraints.append(
                        e11 * dx * dx + 2.0 * e12 * dx * dy + e22 * dy * dy)

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
            col_r = np.full(N, obstacle.radius)
            col_r[0] = 0.1  # dummy radius at k=0
            buf.set(f"ellipsoid_obst_{i}_r", col_r)

            risks = mode_risk_allocation(obstacle.prediction, self.risk,
                                         self.max_modes)
            for j in range(self.max_modes):
                if j >= len(obstacle.prediction.modes):
                    # Absent GMM mode: dummy far-away, unit ellipse
                    buf.set(self._p(i, j, "x"), self._dummy[0])
                    buf.set(self._p(i, j, "y"), self._dummy[1])
                    buf.set(self._p(i, j, "psi"), 0.0)
                    buf.set(self._p(i, j, "major"), 0.0)
                    buf.set(self._p(i, j, "minor"), 0.0)
                    buf.set(self._p(i, j, "chi"), 1.0)
                    continue
                mode = obstacle.prediction.modes[j]
                # Stage k reads prediction step k-1; an empty mode leaves the
                # dummies in place.
                mp = mode_positions(mode)
                psis = np.array([step.angle for step in mode], dtype=float)
                n = min(N - 1, len(mode))
                col_x = np.full(N, self._dummy[0])
                col_y = np.full(N, self._dummy[1])
                col_psi = np.zeros(N)
                col_x[1 : 1 + n] = mp[:n, 0]
                col_y[1 : 1 + n] = mp[:n, 1]
                col_psi[1 : 1 + n] = psis[:n]
                buf.set(self._p(i, j, "x"), col_x)
                buf.set(self._p(i, j, "y"), col_y)
                buf.set(self._p(i, j, "psi"), col_psi)

                if _kind(obstacle.prediction) == PredictionType.GAUSSIAN:
                    chi = float(exponential_quantile(0.5, 1.0 - risks[j]))
                    majors = np.zeros(N)
                    minors = np.zeros(N)
                    majors[1 : 1 + n] = [step.major_radius for step in mode[:n]]
                    minors[1 : 1 + n] = [step.minor_radius for step in mode[:n]]
                    chis = np.full(N, chi)
                    chis[0] = 1.0
                    buf.set(self._p(i, j, "major"), majors)
                    buf.set(self._p(i, j, "minor"), minors)
                    buf.set(self._p(i, j, "chi"), chis)
                else:  # DETERMINISTIC
                    buf.set(self._p(i, j, "major"), 0.0)
                    buf.set(self._p(i, j, "minor"), 0.0)
                    buf.set(self._p(i, j, "chi"), 1.0)

    def is_data_ready(self, data) -> bool:
        if len(data.robot_area) == 0:
            return False
        if len(data.dynamic_obstacles) != self.max_obstacles:
            return False
        for obs in data.dynamic_obstacles:
            if obs.prediction.empty():
                return False
            if _kind(obs.prediction) not in (PredictionType.GAUSSIAN,
                                             PredictionType.DETERMINISTIC):
                return False
        return True

    def missing_data(self, data) -> str:
        return "" if self.is_data_ready(data) else "Obstacles "
