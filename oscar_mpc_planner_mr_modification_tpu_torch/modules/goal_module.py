"""Normalized quadratic distance-to-goal cost, torch counterpart of the JAX
package's ``modules/goal_module.py``: the goal's parameters, and the goal
counts as reached within 1 m."""

from __future__ import annotations

import numpy as np

from .base import ObjectiveModule


class GoalModule(ObjectiveModule):
    module_name = "GoalModule"
    description = "Tracks a goal in 2D"

    def __init__(self, settings):
        self.settings = settings

    def define_parameters(self, params) -> None:
        params.add("goal_weight", add_to_rqt_reconfigure=True)
        params.add("goal_x")
        params.add("goal_y")

    def get_value(self, model, params, settings, stage_idx):
        pos_x = model.get("x")
        pos_y = model.get("y")
        goal_weight = params.get("goal_weight")
        goal_x = params.get("goal_x")
        goal_y = params.get("goal_y")
        # normalized by the goal's squared distance from the origin
        return goal_weight * ((pos_x - goal_x) ** 2 + (pos_y - goal_y) ** 2) / (
            goal_x**2 + goal_y**2 + 0.01
        )

    # -- runtime -----------------------------------------------------------
    def is_data_ready(self, data) -> bool:
        return data.goal_received

    def missing_data(self, data) -> str:
        return "" if data.goal_received else "Goal "

    def set_parameters(self, buf, data, module_data) -> None:
        buf.set("goal_weight", float(self.settings["weights"]["goal"]))
        buf.set("goal_x", float(data.goal[0]))
        buf.set("goal_y", float(data.goal[1]))

    def is_objective_reached(self, state, data) -> bool:
        if not data.goal_received:
            return False
        pos = np.array([state.get("x"), state.get("y")])
        return bool(np.linalg.norm(pos - data.goal) < 1.0)
