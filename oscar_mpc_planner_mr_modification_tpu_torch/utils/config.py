"""Layered YAML configuration.

Replaces the reference's process-wide ``CONFIG`` yaml-cpp singleton
(mpc_planner_util/include/mpc_planner_util/parameters.h:11-52) and the per-system
``config/settings.yaml``. Here configuration is an explicit nested dict (no global
singleton - instances are cheap and are passed explicitly), with
the jackalsimulator defaults reproduced from
mpc_planner_jackalsimulator/config/settings.yaml.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class Config(dict):
    """Nested dict with ``cfg["a"]["b"]`` access plus dotted ``cfg.get_path("a.b")``."""

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def merged_with(self, overrides: Dict[str, Any]) -> "Config":
        out = copy.deepcopy(self)
        _deep_update(out, overrides)
        return out

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f))


def _deep_update(base: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    for key, val in overrides.items():
        if isinstance(val, dict) and isinstance(base.get(key), dict):
            _deep_update(base[key], val)
        else:
            base[key] = copy.deepcopy(val)


def default_settings(**overrides) -> Config:
    """Jackal-simulator default settings (reference settings.yaml values)."""
    cfg = Config(
        {
            "name": "jackal",
            "N": 30,
            "integrator_step": 0.2,
            "n_discs": 1,
            "enable_output": True,
            "control_frequency": 20,
            "solver_settings": {
                "solver": "sqp_ip",  # TPU-native batched SQP + interior-point QP
                "iterations": 10,  # SQP (RTI) iterations per control cycle
                "qp_iterations": 18,  # interior-point iterations per QP subproblem
                "tolstat": 1e-3,
                "dtype": "float32",
            },
            "deceleration_at_infeasible": 3.0,
            "max_obstacles": 4,
            "robot_radius": 0.325,
            "robot": {"length": 0.65, "width": 0.65, "com_to_back": 0.0},
            "obstacle_radius": 0.325,
            "linearized_constraints": {"add_halfspaces": 0},
            "scenario_constraints": {"parallel_solvers": 4, "n_samples": 128,
                                     "confidence": 1e-2, "max_support": 10},
            "decomp": {"range": 2.0, "max_constraints": 12},
            "road": {"two_way": False, "width": 6.0},
            "shift_previous_solution_forward": False,
            "contouring": {
                "dynamic_velocity_reference": False,
                "num_segments": 5,
                "add_road_constraints": True,
            },
            "t-mpc": {
                "use_t-mpc++": True,
                "enable_constraints": True,
                "warmstart_with_mpc_solution": False,
            },
            "probabilistic": {"enable": False, "risk": 0.05,
                              "propagate_uncertainty": True, "max_modes": 1},
            "weights": {
                "goal": 1.0,
                "velocity": 0.55,
                "acceleration": 0.34,
                "angular_velocity": 0.85,
                "reference_velocity": 2.0,
                "contour": 0.05,
                "lag": 0.75,
                "slack": 10000.0,
                "terminal_angle": 100.0,
                "terminal_contouring": 10.0,
                "consistency": 0.05,
            },
            "guidance": {
                "T": 6.0,
                "N": 30,
                "seed": 1,
                "n_paths": 4,
                "comparison_function": "Homology",
                "n_samples": 30,
                "max_velocity": 3.0,
                "max_acceleration": 7.0,
                "longitudinal_goals": 3,
                "vertical_goals": 3,
                "selection_weight_consistency": 0.75,
            },
            "JULES": {
                "assign_meaningful_topology_id_to_non_guided": True,
                "override_selected_traject_of_topology_non_guided": True,
                "communicate_on_topology_switch_only": True,
                "n_paths": 4,
                "enable_trajectory_interpolation": True,
                # Synchronized startup barrier (FSM states 4/5). The
                # reference declares the chain (data_types.h:180-181) but its
                # entry is commented out (jules_ros1_jackalplanner.cpp:433);
                # here it is live behind this flag.
                "synchronized_start": False,
                "robot_max_velocity": 2.5,
                "robot_max_angular_velocity": 2.5,
                "max_geometric_deviation": 5.0,
                "heartbeat_time": 2.0,
                "consistency_enabled": True,
                "consistency_on_non_guided_planner": True,
            },
        }
    )
    if overrides:
        cfg = cfg.merged_with(overrides)
    return cfg
