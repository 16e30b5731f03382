"""SH-MPC scenario constraints, torch counterpart of the JAX package's
``modules/scenario_constraints.py``: 24 halfspaces per disc, each softened
by the model's slack state, ``a1 px + a2 py - (b + slack) <= 0`` at the disc
position. The rows' parameters are filled per parallel solver from sampled
obstacle scenarios by :class:`..parallel.scenario.ScenarioOptimizer`, which
:func:`..factory.build_planner` attaches and this module's ``optimize``
hands the tick to. With ``n_discs > 1`` every disc has its own 24 rows (the
JAX package's count, consistent for any disc count).
"""

from __future__ import annotations

import numpy as np

from .base import ConstraintModule, ego_disc_position, EXIT_CODE_NOT_OPTIMIZED_YET
from ..types import PredictionType

N_SCENARIO_CONSTRAINTS = 24  # halfspaces per disc


class ScenarioConstraintModule(ConstraintModule):
    module_name = "ScenarioConstraints"
    description = "Avoid dynamic obstacles under motion uncertainty (SH-MPC)"

    def __init__(self, settings):
        self.settings = settings
        self.n_discs = settings["n_discs"]
        self.n_per_disc = N_SCENARIO_CONSTRAINTS
        self.n_constraints = self.n_per_disc * self.n_discs
        self.nh = self.n_constraints
        self.use_slack = True
        self._optimizer = None  # a parallel.scenario.ScenarioOptimizer

    def _constraint_name(self, index: int, disc_id: int) -> str:
        return f"disc_{disc_id}_scenario_constraint_{index}"

    # -- symbolic ----------------------------------------------------------
    def define_parameters(self, params) -> None:
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
            for i in range(self.n_per_disc):
                params.add(self._constraint_name(i, d) + "_a1")
                params.add(self._constraint_name(i, d) + "_a2")
                params.add(self._constraint_name(i, d) + "_b")

    def get_lower_bound(self):
        return [-np.inf] * self.n_constraints

    def get_upper_bound(self):
        return [0.0] * self.n_constraints

    def get_constraints(self, model, params, settings, stage_idx):
        constraints = []
        slack = model.get("slack") if self.use_slack else 0.0
        for d in range(self.n_discs):
            px, py = ego_disc_position(model, params, d)
            for i in range(self.n_per_disc):
                a1 = params.get(self._constraint_name(i, d) + "_a1")
                a2 = params.get(self._constraint_name(i, d) + "_a2")
                b = params.get(self._constraint_name(i, d) + "_b")
                if self.use_slack:
                    constraints.append(a1 * px + a2 * py - (b + slack))
                else:
                    constraints.append(a1 * px + a2 * py - b)
        return constraints

    # -- runtime -----------------------------------------------------------
    def set_parameters(self, buf, data, module_data) -> None:
        """Disc offsets and far-away dummy halfspaces; the scenario optimizer
        overwrites the halfspace rows per parallel solver from its own
        samples."""
        for d in range(self.n_discs):
            if len(data.robot_area) > d:
                buf.set(f"ego_disc_{d}_offset", data.robot_area[d].offset)
            for i in range(self.n_per_disc):
                name = self._constraint_name(i, d)
                buf.set(name + "_a1", 1.0)
                buf.set(name + "_a2", 0.0)
                buf.set(name + "_b", 1.0e4)

    def attach_optimizer(self, optimizer) -> None:
        self._optimizer = optimizer

    def optimize(self, state, data, module_data) -> int:
        if self._optimizer is None:
            return EXIT_CODE_NOT_OPTIMIZED_YET
        return self._optimizer.optimize(state, data, module_data)

    def on_data_received(self, data, data_name: str) -> None:
        if data_name == "dynamic obstacles" and self._optimizer is not None:
            self._optimizer.sample_scenarios(data)

    def is_data_ready(self, data) -> bool:
        if len(data.dynamic_obstacles) != self.settings["max_obstacles"]:
            return False
        return all(not o.prediction.empty()
                   and o.prediction.type.name == PredictionType.GAUSSIAN.name
                   for o in data.dynamic_obstacles)
