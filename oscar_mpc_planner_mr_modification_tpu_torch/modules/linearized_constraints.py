"""Linearized dynamic collision-avoidance constraints, torch counterpart of the
JAX package's ``modules/linearized_constraints.py``.

Symbolic: halfspaces ``a1 x + a2 y <= b (+ slack)`` per disc x obstacle; the
expressions are plain arithmetic on tensors. Runtime (numpy): per stage and
disc, project the ego prediction out of obstacle discs, then build a
normal-vector halfspace per obstacle from its position at prediction step k-1;
append static halfspaces from module_data; fill unused rows with dummies.
``set_topology_constraints()`` switches to the single-disc guidance mode used by
T-MPC (radius 1e-3). ``self.solver`` is any object with ``N`` and
``get_ego_prediction(k, name)``.
"""

from __future__ import annotations

import numpy as np

from .base import ConstraintModule, ego_disc_position


def _project_outside_discs(pos, centers, radii, anchor, iterations: int = 3):
    """Iterated projection of ``pos`` outside all discs (centers, radii).

    Returns a collision-free linearization point.
    """
    p = pos.copy()
    for _ in range(iterations):
        for c, r in zip(centers, radii):
            d = p - c
            dist = np.linalg.norm(d)
            if dist < 1e-9:
                direction = anchor - c
                n = np.linalg.norm(direction)
                direction = direction / n if n > 1e-9 else np.array([1.0, 0.0])
                p = c + r * direction
            elif dist < r:
                p = c + d * (r / dist)
    return p


class LinearizedConstraintModule(ConstraintModule):
    module_name = "LinearizedConstraints"
    description = "Linearized dynamic collision avoidance constraints"

    def __init__(self, settings, use_slack: bool = False):
        self.settings = settings
        self.n_discs = settings["n_discs"]
        self.max_obstacles = settings["max_obstacles"]
        self.n_other_halfspaces = settings["linearized_constraints"]["add_halfspaces"]
        self.use_slack = use_slack
        self.use_guidance = False
        self.robot_radius = settings["robot_radius"]
        self.nh = (self.max_obstacles + self.n_other_halfspaces) * self.n_discs
        self.solver = None
        # (n_discs, N, rows) filled by update()
        self._a1 = self._a2 = self._b = None
        self._dummy_a1, self._dummy_a2 = 1.0, 0.0
        self._dummy_b = 100.0

    def set_topology_constraints(self) -> None:
        """Guidance/T-MPC mode: one disc, tiny radius."""
        self.n_discs = 1
        self.use_guidance = True
        self.nh = self.max_obstacles + self.n_other_halfspaces

    # -- symbolic ----------------------------------------------------------
    def _constraint_name(self, index: int, disc_id: int) -> str:
        if self.use_guidance:
            return f"lin_constraint_{index}"
        return f"disc_{disc_id}_lin_constraint_{index}"

    def define_parameters(self, params) -> None:
        for d in range(self.n_discs):
            if not self.use_guidance:
                params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
            for i in range(self.max_obstacles + self.n_other_halfspaces):
                params.add(self._constraint_name(i, d) + "_a1",
                           bundle_name="lin_constraint_a1")
                params.add(self._constraint_name(i, d) + "_a2",
                           bundle_name="lin_constraint_a2")
                params.add(self._constraint_name(i, d) + "_b",
                           bundle_name="lin_constraint_b")

    def get_lower_bound(self):
        return [-np.inf] * self.nh

    def get_upper_bound(self):
        return [0.0] * self.nh

    def get_constraints(self, model, params, settings, stage_idx):
        constraints = []
        try:
            slack = model.get("slack") if self.use_slack else 0.0
        except KeyError:
            slack = 0.0
        for d in range(self.n_discs):
            if self.use_guidance:
                px = model.get("x")
                py = model.get("y")
            else:
                px, py = ego_disc_position(model, params, d)
            for i in range(self.max_obstacles + self.n_other_halfspaces):
                a1 = params.get(self._constraint_name(i, d) + "_a1")
                a2 = params.get(self._constraint_name(i, d) + "_a2")
                b = params.get(self._constraint_name(i, d) + "_b")
                constraints.append(a1 * px + a2 * py - (b + slack))
        return constraints

    # -- runtime -----------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        self._dummy_b = state.get("x") + 100.0
        N = self.solver.N
        rows = self.max_obstacles + self.n_other_halfspaces
        obstacles = data.dynamic_obstacles
        self._a1 = np.full((self.n_discs, N, rows), self._dummy_a1)
        self._a2 = np.full((self.n_discs, N, rows), self._dummy_a2)
        self._b = np.full((self.n_discs, N, rows), self._dummy_b)

        for k in range(1, N):
            # Clamp the prediction step for short predictions (matches the
            # sibling modules' min(k-1, len(mode)-1) handling).
            centers = [
                obs.prediction.modes[0][min(k - 1, len(obs.prediction.modes[0]) - 1)]
                .position for obs in obstacles
            ]
            radii = [
                (1e-3 if self.use_guidance else obs.radius) + self.robot_radius
                for obs in obstacles
            ]
            anchor = centers[0] if centers else np.zeros(2)
            for d in range(self.n_discs):
                pos = np.array([
                    self.solver.get_ego_prediction(k, "x"),
                    self.solver.get_ego_prediction(k, "y"),
                ])
                if not self.use_guidance and len(data.robot_area) > d:
                    disc = data.robot_area[d]
                    pos = disc.get_position(pos, self.solver.get_ego_prediction(k, "psi"))
                if centers:
                    pos = _project_outside_discs(pos, centers, radii, anchor)

                for i, obs in enumerate(obstacles):
                    mode = obs.prediction.modes[0]
                    opos = mode[min(k - 1, len(mode) - 1)].position
                    diff = opos - pos
                    dist = np.linalg.norm(diff)
                    if dist < 1e-9:
                        continue
                    a1, a2 = diff[0] / dist, diff[1] / dist
                    radius = 1e-3 if self.use_guidance else obs.radius
                    self._a1[d, k, i] = a1
                    self._a2[d, k, i] = a2
                    self._b[d, k, i] = (a1 * opos[0] + a2 * opos[1]
                                        - (radius + self.robot_radius))

                if module_data.static_obstacles is not None:
                    hs = module_data.static_obstacles[k]
                    for h in range(min(len(hs), self.n_other_halfspaces)):
                        i = len(obstacles) + h
                        self._a1[d, k, i] = hs[h].A[0]
                        self._a2[d, k, i] = hs[h].A[1]
                        self._b[d, k, i] = hs[h].b

    def set_parameters(self, buf, data, module_data) -> None:
        N = buf.N
        for d in range(self.n_discs):
            if not self.use_guidance and len(data.robot_area) > d:
                buf.set(f"ego_disc_{d}_offset", data.robot_area[d].offset)
            for i in range(self.max_obstacles + self.n_other_halfspaces):
                name = self._constraint_name(i, d)
                col_a1 = np.full(N, self._dummy_a1)
                col_a2 = np.full(N, self._dummy_a2)
                col_b = np.full(N, self._dummy_b)
                if self._a1 is not None:
                    col_a1[1:] = self._a1[d, 1:, i]
                    col_a2[1:] = self._a2[d, 1:, i]
                    col_b[1:] = self._b[d, 1:, i]
                buf.set(name + "_a1", col_a1)
                buf.set(name + "_a2", col_a2)
                buf.set(name + "_b", col_b)

    def is_data_ready(self, data) -> bool:
        if len(data.dynamic_obstacles) != self.max_obstacles:
            return False
        return all(not o.prediction.empty() for o in data.dynamic_obstacles)

    def missing_data(self, data) -> str:
        return "" if self.is_data_ready(data) else "Obstacles "
