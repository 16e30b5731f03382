"""Planner configurations: each ``configuration_*`` assembles a (model,
modules) pair, as the JAX package's ``factory.py`` does for the same names;
:func:`build_planner` wires the runtime (OCP, Solver, Planner and the T-MPC
or scenario optimizer) and :func:`prewarm_planner` builds the kernels
before the first control tick."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .models import (BicycleModel2ndOrder,
                     BicycleModel2ndOrderCurvatureAware,
                     ContouringSecondOrderUnicycleModel,
                     ContouringSecondOrderUnicycleModelWithSlack,
                     SecondOrderUnicycleModel)
from .modules import (ConsistencyModule, ContouringModule,
                      EllipsoidConstraintModule, GoalModule,
                      GuidanceConstraintModule, MPCBaseModule, ModuleManager,
                      PathReferenceVelocityModule, ScenarioConstraintModule)
from .ops.sqp import SQPConfig
from .planner import Planner
from .solver import Solver, build_ocp


def configuration_no_obstacles(settings):
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()

    base_module = modules.add_module(MPCBaseModule(settings))
    base_module.weigh_variable("a", "acceleration")
    base_module.weigh_variable("w", "angular_velocity")
    _add_contouring(modules, base_module, settings)
    return model, modules


def _add_contouring(modules, base_module, settings):
    """MPCBase weighs v toward the constant reference velocity, or, under
    ``contouring/dynamic_velocity_reference``, the contouring cost tracks
    the PathReferenceVelocity module's spline instead."""
    dynamic = settings["contouring"]["dynamic_velocity_reference"]
    if not dynamic:
        base_module.weigh_variable(
            "v", ["velocity", "reference_velocity"],
            cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    modules.add_module(ContouringModule(settings))
    if dynamic:
        modules.add_module(PathReferenceVelocityModule(settings))


def configuration_basic(settings):
    model, modules = configuration_no_obstacles(settings)
    modules.add_module(EllipsoidConstraintModule(settings))
    return model, modules


def configuration_tmpc(settings, constraint_submodule=None):
    """T-MPC++ without the consistency cost."""
    model, modules = configuration_no_obstacles(settings)
    modules.add_module(GuidanceConstraintModule(
        settings, constraint_submodule=constraint_submodule))
    return model, modules


def configuration_tmpc_consistency_cost(settings, constraint_submodule=None):
    """The T-MPC++ configuration with the consistency cost (the bench OCP)."""
    model, modules = configuration_no_obstacles(settings)
    if settings["JULES"]["consistency_enabled"]:
        modules.add_module(ConsistencyModule(settings))
    modules.add_module(GuidanceConstraintModule(
        settings, constraint_submodule=constraint_submodule))
    return model, modules


def configuration_safe_horizon(settings):
    """SH-MPC: the contouring unicycle with a slack state, MPCBase weighing
    a, w, slack and v, contouring and the scenario constraints."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModelWithSlack()
    base_module = modules.add_module(MPCBaseModule(settings))
    base_module.weigh_variable("a", "acceleration")
    base_module.weigh_variable("w", "angular_velocity")
    base_module.weigh_variable("slack", "slack")
    _add_contouring(modules, base_module, settings)
    modules.add_module(ScenarioConstraintModule(settings))
    return model, modules


def configuration_lmpcc(settings):
    """LMPCC: goal tracking with ellipsoid obstacle constraints on the
    contouring unicycle, MPCBase weighing a and w; the PathReferenceVelocity
    module declares its spline (zero cost without a contouring module)."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()
    base_module = modules.add_module(MPCBaseModule(settings))
    base_module.weigh_variable("a", "acceleration")
    base_module.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(settings))
    modules.add_module(PathReferenceVelocityModule(settings))
    modules.add_module(EllipsoidConstraintModule(settings))
    return model, modules


def configuration_goal_tmpc(settings, constraint_submodule=None):
    """Goal-tracking T-MPC (no reference path) on the second-order
    unicycle: the planner of the multi-robot driver."""
    modules = ModuleManager()
    model = SecondOrderUnicycleModel()
    base_module = modules.add_module(MPCBaseModule(settings))
    base_module.weigh_variable("a", "acceleration")
    base_module.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(settings))
    if settings["JULES"]["consistency_enabled"]:
        modules.add_module(ConsistencyModule(settings))
    modules.add_module(GuidanceConstraintModule(
        settings, constraint_submodule=constraint_submodule))
    return model, modules


def configuration_bicycle(settings, curvature_aware: bool = False):
    """The Prius-like bicycle contouring configuration: the bicycle model
    (or its curvature-aware variant), MPCBase weighing a, w, the slack input
    and v, contouring and ellipsoid obstacle constraints."""
    modules = ModuleManager()
    model = (BicycleModel2ndOrderCurvatureAware() if curvature_aware
             else BicycleModel2ndOrder())
    base_module = modules.add_module(MPCBaseModule(settings))
    base_module.weigh_variable("a", "acceleration")
    base_module.weigh_variable("w", "angular_velocity")
    base_module.weigh_variable("slack", "slack")
    base_module.weigh_variable(
        "v", ["velocity", "reference_velocity"],
        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    modules.add_module(ContouringModule(settings))
    modules.add_module(EllipsoidConstraintModule(settings))
    return model, modules


def build_planner(model, modules, settings, dtype=torch.float64,
                  sqp_config: Optional[SQPConfig] = None, clock=None,
                  device="cuda") -> Planner:
    """Assemble OCP, Solver and Planner and attach the T-MPC optimizer to a
    guidance module, the scenario optimizer to a scenario module. The solves
    run on ``device`` (pass ``"cpu"`` for the plain versions); each
    optimizer picks its fleet backend from the config and raises here for
    an OCP its kernels do not cover."""
    from .parallel.scenario import ScenarioOptimizer
    from .parallel.tmpc import TMPCOptimizer

    ocp = build_ocp(model, modules, settings)
    solver = Solver(ocp, settings, dtype=dtype, sqp_config=sqp_config,
                    device=device)
    planner = Planner(solver, modules, settings)
    for module in modules:
        if isinstance(module, GuidanceConstraintModule):
            module.attach_optimizer(TMPCOptimizer(
                solver, settings, clock=clock or time.monotonic))
        if isinstance(module, ScenarioConstraintModule):
            module.attach_optimizer(ScenarioOptimizer(solver, settings))
    return planner


def prewarm_planner(planner: Planner, model, settings,
                    start_pose=(0.0, 0.0, 0.0), goal=(5.0, 0.0)) -> None:
    """Run one tick on a benign synthetic scene, then reset: the kernels and
    the PRM library build (seconds) before the first real control tick."""
    from .planner.data_preparation import (define_robot_area,
                                           get_constant_velocity_prediction)
    from .solver import State
    from .types import DynamicObstacle, RealTimeData, ReferencePath

    state = State(model)
    state.set("x", float(start_pose[0]))
    state.set("y", float(start_pose[1]))
    state.set("psi", float(start_pose[2]))
    state.set("v", 0.1)
    data = RealTimeData()
    data.robot_area = define_robot_area(
        settings["robot"]["length"], settings["robot"]["width"],
        settings["n_discs"])
    data.goal = np.asarray(goal, dtype=float)
    data.goal_received = True
    far = np.asarray(start_pose[:2], dtype=float) + 50.0
    obstacles = []
    for i in range(int(settings["max_obstacles"])):
        o = DynamicObstacle(index=i, position=far.copy(), radius=0.3)
        o.prediction = get_constant_velocity_prediction(
            far, np.zeros(2), planner.solver.dt, planner.solver.N,
            probabilistic=bool(settings["probabilistic"]["enable"]))
        obstacles.append(o)
    data.dynamic_obstacles = obstacles
    # Path-following configurations also gate on a reference path: a long
    # straight one through the start pose.
    xs = [float(start_pose[0]) + 5.0 * k for k in range(11)]
    data.reference_path = ReferencePath(x=xs, y=[float(start_pose[1])] * 11)
    planner.on_data_received(data, "reference_path")
    planner.solve_mpc(state, data)
    planner.reset(None, None)
