"""System presets and integration interfaces, counterpart of the JAX
package's ``systems.py``:

- :func:`jackalsimulator_settings` / :func:`jackal_settings` /
  :func:`dingo_settings`: the per-system settings overlays;
- :func:`make_system_planner`: build the configured planner for a system and
  a configuration name (all six of :data:`CONFIGURATIONS`), on the card
  unless ``device="cpu"``;
- :class:`LocalPlannerInterface`: the move_base local-planner plugin shape
  (set_plan / compute_velocity_commands / is_goal_reached);
  :meth:`~LocalPlannerInterface.set_costmap` hands the occupancy costmap to
  the decomp constraints (``modules/decomp_constraints.py``) of a
  configuration that has them;
- :class:`WeightTuner`: live tuning of the declared weight parameters,
  clamped to their ranges, applied on the next control cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from .factory import (build_planner, configuration_basic,
                      configuration_goal_tmpc, configuration_lmpcc,
                      configuration_safe_horizon, configuration_tmpc,
                      configuration_tmpc_consistency_cost)
from .utils.config import Config, default_settings

CONFIGURATIONS = {
    "basic": configuration_basic,
    "lmpcc": configuration_lmpcc,
    "tmpc": configuration_tmpc,
    "tmpc_consistency_cost": configuration_tmpc_consistency_cost,
    "goal_tmpc": configuration_goal_tmpc,
    "safe_horizon": configuration_safe_horizon,
}


def jackalsimulator_settings(**overrides) -> Config:
    """The default settings ARE the jackalsimulator profile (settings.yaml)."""
    return default_settings(**overrides)


def jackal_settings(**overrides) -> Config:
    """Real Jackal (Vicon): tighter speeds, conservative obstacles
    (mpc_planner_jackal/config/settings.yaml highlights)."""
    cfg = default_settings(
        name="jackal_real",
        control_frequency=20,
        max_obstacles=6,
        weights={"reference_velocity": 1.25},
    )
    return cfg.merged_with(overrides) if overrides else cfg


def dingo_settings(**overrides) -> Config:
    """Dingo: smaller footprint, slower (mpc_planner_dingo)."""
    cfg = default_settings(
        name="dingo",
        robot_radius=0.25,
        robot={"length": 0.5, "width": 0.5, "com_to_back": 0.0},
        weights={"reference_velocity": 1.0},
    )
    return cfg.merged_with(overrides) if overrides else cfg


def make_system_planner(system: str = "jackalsimulator",
                        configuration="tmpc_consistency_cost",
                        dtype=None, sqp_config=None, clock=None,
                        device="cuda", **overrides):
    """Build the configured planner for a system (the node initializer):
    ``(planner, model, settings)``. ``configuration`` names one of
    :data:`CONFIGURATIONS`, or is a function ``settings -> (model,
    modules)`` like them (e.g. one that adds ``DecompConstraintModule``).
    The solves run on ``device`` (pass ``"cpu"`` for the plain versions) in
    ``dtype`` (f64 by default, as the JAX package's)."""
    settings_fn = {
        "jackalsimulator": jackalsimulator_settings,
        "jackal": jackal_settings,
        "dingo": dingo_settings,
        "rosnavigation": jackalsimulator_settings,
    }[system]
    settings = settings_fn(**overrides)
    configure = (CONFIGURATIONS[configuration]
                 if isinstance(configuration, str) else configuration)
    model, modules = configure(settings)
    planner = build_planner(model, modules, settings,
                            dtype=dtype or torch.float64,
                            sqp_config=sqp_config, clock=clock,
                            device=device)
    return planner, model, settings


class WeightTuner:
    """Live weight tuning (rqt_reconfigure equivalent).

    The runtime modules re-read ``settings["weights"]`` every cycle
    (mpc_base.cpp:23-35 semantics), so mutating them here takes effect on the
    next solve. Only weights declared by the modules are accepted.
    """

    def __init__(self, planner):
        self.planner = planner
        self.settings = planner.settings
        reg = planner.solver.ocp.registry
        self._tunable = set(reg.rqt_params)
        # Slider ranges from the registry metadata (reference rqt_reconfigure
        # .cfg generation, solver_generator/util/parameters.py:25-62 +
        # generate_cpp_files.py:263-349): values outside [min, max] are
        # clamped, exactly like an rqt slider cannot leave its range.
        self._ranges = {name: reg.rqt_range(name) for name in reg.rqt_params}

    @property
    def tunable(self):
        return sorted(self._tunable)

    def range(self, name: str):
        """(min, max) slider range of a tunable weight (0..100 default)."""
        return self._ranges.get(name, (0.0, 100.0))

    def get(self, name: str) -> float:
        return float(self.settings["weights"][name])

    def set(self, name: str, value: float) -> None:
        if name not in self._tunable and name not in self.settings["weights"]:
            raise KeyError(f"'{name}' is not a declared tunable weight; "
                           f"available: {self.tunable}")
        lo, hi = self.range(name)
        self.settings["weights"][name] = min(max(float(value), lo), hi)


class LocalPlannerInterface:
    """move_base-style local planner plugin (rosnavigation equivalent)."""

    def __init__(self, system: str = "rosnavigation",
                 configuration="basic", device="cuda", **overrides):
        self.planner, self.model, self.settings = make_system_planner(
            system, configuration, device=device, **overrides)
        from .planner.data_preparation import define_robot_area
        from .solver import State
        from .types import RealTimeData

        self.state = State(self.model)
        self.data = RealTimeData()
        self.data.robot_area = define_robot_area(
            self.settings["robot"]["length"], self.settings["robot"]["width"],
            self.settings["n_discs"])
        self._plan_set = False

    def set_plan(self, path_xy: np.ndarray) -> bool:
        """Receive the global plan (setPlan)."""
        self.data.reference_path.x = list(np.asarray(path_xy)[:, 0])
        self.data.reference_path.y = list(np.asarray(path_xy)[:, 1])
        self.planner.on_data_received(self.data, "reference_path")
        self._plan_set = True
        return True

    def set_costmap(self, costmap) -> None:
        """Hand the occupancy costmap to the decomp constraints: the
        planner's data carries it into ``DecompConstraintModule.update`` on
        each cycle."""
        self.data.costmap = costmap

    def set_obstacles(self, obstacles) -> None:
        from .planner.data_preparation import ensure_obstacle_size

        self.data.dynamic_obstacles = ensure_obstacle_size(
            list(obstacles), self.state, self.settings["max_obstacles"],
            self.planner.solver.N, self.planner.solver.dt,
            probabilistic=self.settings["probabilistic"]["enable"])

    def compute_velocity_commands(self, pose_xyyaw, velocity: float):
        """One control cycle: returns (v, w, success)."""
        self.state.set("x", pose_xyyaw[0])
        self.state.set("y", pose_xyyaw[1])
        self.state.set("psi", pose_xyyaw[2])
        self.state.set("v", velocity)
        if not self.data.dynamic_obstacles:
            self.set_obstacles([])
        output = self.planner.solve_mpc(self.state, self.data)
        if not output.success:
            return 0.0, 0.0, False
        # Reference command extraction: v from stage 1, w from stage 0
        # (ros1_jackalsimulator.cpp:181-201)
        v_cmd = self.planner.get_solution(1, "v")
        w_cmd = self.planner.get_solution(0, "w")
        return float(v_cmd), float(w_cmd), True

    def is_goal_reached(self) -> bool:
        return self.planner.is_objective_reached(self.state, self.data)
