"""T-MPC++ guidance constraints, torch counterpart of the JAX package's
``modules/guidance_constraints.py``.

Symbolic: one halfspace per obstacle (single-disc topology constraints
linearized around the guidance trajectory) plus an embedded safety submodule
(default: ellipsoid constraints). The planner axis (n_paths guided + 1
unguided) is a batch dimension of the fleet solver
(:mod:`..parallel.batch`); the per-planner topology parameters are rows of the
fleet's parameter tensor. At runtime the module runs the guidance search in
``update`` and hands ``optimize`` (and its pipelined halves) to the attached
:class:`..parallel.tmpc.TMPCOptimizer`.
"""

from __future__ import annotations

from .base import ConstraintModule, EXIT_CODE_NOT_OPTIMIZED_YET
from .ellipsoid_constraints import EllipsoidConstraintModule
from .linearized_constraints import LinearizedConstraintModule


class GuidanceConstraintModule(ConstraintModule):
    module_name = "GuidanceConstraints"
    description = "T-MPC++: optimize over homotopy-distinct guidance trajectories"

    def __init__(self, settings, constraint_submodule=None):
        self.settings = settings
        submodule_cls = constraint_submodule or EllipsoidConstraintModule

        # Topology constraints: single-disc linearized halfspaces w.r.t. guidance
        self.topology_constraints = LinearizedConstraintModule(settings)
        self.topology_constraints.set_topology_constraints()

        # Safety constraints
        self.constraint_submodule = submodule_cls(settings)

        self.nh = self.topology_constraints.nh + self.constraint_submodule.nh
        self._optimizer = None  # the TMPCOptimizer, wired by build_planner

    # -- symbolic: topology halfspaces + embedded safety constraints -------
    def define_parameters(self, params) -> None:
        self.topology_constraints.define_parameters(params)
        self.constraint_submodule.define_parameters(params)

    def get_lower_bound(self):
        return (self.topology_constraints.get_lower_bound()
                + self.constraint_submodule.get_lower_bound())

    def get_upper_bound(self):
        return (self.topology_constraints.get_upper_bound()
                + self.constraint_submodule.get_upper_bound())

    def get_constraints(self, model, params, settings, stage_idx):
        return (self.topology_constraints.get_constraints(model, params, settings,
                                                          stage_idx)
                + self.constraint_submodule.get_constraints(model, params, settings,
                                                            stage_idx))

    # -- runtime -----------------------------------------------------------
    def attach_optimizer(self, optimizer) -> None:
        self._optimizer = optimizer

    @property
    def solver(self):
        return getattr(self, "_solver", None)

    @solver.setter
    def solver(self, value):
        self._solver = value
        self.topology_constraints.solver = value
        self.constraint_submodule.solver = value

    def update(self, state, data, module_data) -> None:
        self.constraint_submodule.update(state, data, module_data)
        if self._optimizer is not None:
            self._optimizer.update(state, data, module_data)

    def set_parameters(self, buf, data, module_data) -> None:
        # Baseline fill: safety constraints + inactive topology halfspaces.
        self.constraint_submodule.set_parameters(buf, data, module_data)
        for i in range(self.topology_constraints.max_obstacles
                       + self.topology_constraints.n_other_halfspaces):
            buf.set(f"lin_constraint_{i}_a1", 1.0)
            buf.set(f"lin_constraint_{i}_a2", 0.0)
            buf.set(f"lin_constraint_{i}_b", 1.0e4)

    def optimize(self, state, data, module_data) -> int:
        if self._optimizer is None:
            return EXIT_CODE_NOT_OPTIMIZED_YET
        return self._optimizer.optimize(state, data, module_data)

    def optimize_dispatch(self, state, data, module_data):
        if self._optimizer is None:
            return None
        return self._optimizer.optimize_dispatch(state, data, module_data)

    def optimize_finish(self, state, data, module_data) -> int:
        return self._optimizer.optimize_finish(module_data)

    def is_data_ready(self, data) -> bool:
        return self.constraint_submodule.is_data_ready(data)

    def missing_data(self, data) -> str:
        return self.constraint_submodule.missing_data(data)

    def reset(self) -> None:
        if self._optimizer is not None:
            self._optimizer.reset()
