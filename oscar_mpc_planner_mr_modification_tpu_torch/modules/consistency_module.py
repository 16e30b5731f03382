"""Temporal-consistency cost versus the previously planned trajectory, torch
counterpart of the JAX package's ``modules/consistency_module.py``. Its
per-planner parameters are filled by the T-MPC optimizer; the module's own
runtime fill is empty."""

from __future__ import annotations

from .base import ObjectiveModule


class ConsistencyModule(ObjectiveModule):
    module_name = "ConsistencyModule"
    description = "Penalizes deviation from the previous planned trajectory"

    def __init__(self, settings):
        self.settings = settings
        self.N = settings["N"]

    def define_parameters(self, params) -> None:
        params.add("consistency_weight", add_to_rqt_reconfigure=True)
        params.add("prev_traj_x")
        params.add("prev_traj_y")

    def get_value(self, model, params, settings, stage_idx):
        pos_x = model.get("x")
        pos_y = model.get("y")
        w = params.get("consistency_weight")
        prev_x = params.get("prev_traj_x")
        prev_y = params.get("prev_traj_y")
        return w * ((pos_x - prev_x) ** 2 + (pos_y - prev_y) ** 2)

    def set_parameters(self, buf, data, module_data) -> None:
        pass
