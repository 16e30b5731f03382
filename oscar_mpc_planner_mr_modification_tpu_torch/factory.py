"""Planner configurations: each ``configuration_*`` assembles a (model,
modules) pair, as the JAX package's ``factory.py`` does for the same names."""

from __future__ import annotations

from .models import ContouringSecondOrderUnicycleModel
from .modules import (ConsistencyModule, ContouringModule,
                      EllipsoidConstraintModule, GuidanceConstraintModule,
                      MPCBaseModule, ModuleManager)


def configuration_no_obstacles(settings):
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()

    base_module = modules.add_module(MPCBaseModule(settings))
    base_module.weigh_variable("a", "acceleration")
    base_module.weigh_variable("w", "angular_velocity")
    if settings["contouring"]["dynamic_velocity_reference"]:
        raise NotImplementedError(
            "contouring/dynamic_velocity_reference needs the "
            "PathReferenceVelocity module, which this package does not have yet")
    base_module.weigh_variable(
        "v", ["velocity", "reference_velocity"],
        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)

    modules.add_module(ContouringModule(settings))
    return model, modules


def configuration_basic(settings):
    model, modules = configuration_no_obstacles(settings)
    modules.add_module(EllipsoidConstraintModule(settings))
    return model, modules


def configuration_tmpc_consistency_cost(settings, constraint_submodule=None):
    """The T-MPC++ configuration with the consistency cost (the bench OCP)."""
    model, modules = configuration_no_obstacles(settings)
    if settings["JULES"]["consistency_enabled"]:
        modules.add_module(ConsistencyModule(settings))
    modules.add_module(GuidanceConstraintModule(
        settings, constraint_submodule=constraint_submodule))
    return model, modules
