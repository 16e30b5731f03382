"""Every configuration of the JAX package's configuration sweep
(tests/test_config_sweep.py) that the port has, through the port's full
planner path on the CPU (``device="cpu"``): OCP assembly, runtime module
updates, the parameter fill, the solve, output extraction. Each must give
a finite plan, solve at least 2 of 3 ticks and move forward, the JAX
test's assertions. The planners without a guidance or scenario module
solve through ``Solver.solve``; the others through their optimizer's
fleet backend (the plain versions on the CPU). The bicycle's third input,
its slack, is held at 0 when the robot moves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscar_mpc_planner_mr_modification_tpu_torch import factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.multirobot.driver import (  # noqa: E402
    integrate_on_host)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E402
    define_robot_area, ensure_obstacle_size)
from oscar_mpc_planner_mr_modification_tpu_torch.sim import (  # noqa: E402
    Pedestrian, PedestrianSimulator)
from oscar_mpc_planner_mr_modification_tpu_torch.sim.roadmap import (  # noqa: E402
    straight_path)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import State  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.types import RealTimeData  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

N = 8

CONFIGS = [
    ("no_obstacles", factory.configuration_no_obstacles, {}),
    ("no_obstacles_dynvref", factory.configuration_no_obstacles,
     {"contouring.dynamic_velocity_reference": True}),
    ("basic", factory.configuration_basic, {}),
    ("lmpcc", factory.configuration_lmpcc, {}),
    ("tmpc", factory.configuration_tmpc, {}),
    ("tmpc_consistency", factory.configuration_tmpc_consistency_cost, {}),
    ("goal_tmpc", factory.configuration_goal_tmpc, {}),
    ("safe_horizon", factory.configuration_safe_horizon,
     {"scenario_constraints.n_samples": 24, "probabilistic.enable": True,
      "_probabilistic_obstacles": True}),
    ("bicycle", factory.configuration_bicycle, {}),
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _apply_overrides(settings, overrides):
    for key, value in overrides.items():
        if key.startswith("_"):
            continue
        node = settings
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return settings


@pytest.mark.parametrize("name,conf,overrides", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_configuration_full_planner_ticks(name, conf, overrides):
    settings = _apply_overrides(
        default_settings(N=N, max_obstacles=2), overrides)
    model, modules = conf(settings)
    cfg = SQPConfig(n_sqp=6, n_qp_iter=10, mu_min=1e-9)
    planner = factory.build_planner(model, modules, settings,
                                    dtype=torch.float64, sqp_config=cfg,
                                    device="cpu")
    state = State(model)
    state.set("v", 0.6)
    psim = PedestrianSimulator(
        [Pedestrian(np.array([6.0, 2.0]), np.array([6.0, -2.0]))], dt=0.2)
    n_ok = 0
    for tick in range(3):
        data = RealTimeData()
        data.robot_area = define_robot_area(0.65, 0.65, 1)
        data.reference_path = straight_path(length=20.0)
        data.goal = np.array([6.0, 0.0])
        data.goal_received = True
        prob = overrides.get("_probabilistic_obstacles", False)
        data.dynamic_obstacles = ensure_obstacle_size(
            psim.get_obstacles(N, probabilistic=prob), state,
            settings["max_obstacles"], N, 0.2, probabilistic=prob)
        if tick == 0:
            planner.on_data_received(data, "reference_path")
            planner.on_data_received(data, "goal")
            planner.on_data_received(data, "dynamic obstacles")
        out = planner.solve_mpc(state, data)
        assert np.isfinite(planner.solver.get_output_trajectory()).all(), name
        if out.success:
            n_ok += 1
            a = planner.get_solution(0, "a")
            w = planner.get_solution(0, "w")
            assert np.isfinite(a) and np.isfinite(w), name
            x = integrate_on_host(model, state.as_array(),
                                  [a, w] + [0.0] * (model.nu - 2), 0.2)
            x[model.state_index("v")] = max(x[model.state_index("v")], 0.0)
            state.set_array(x)
        psim.step([state.get_position()])
    assert n_ok >= 2, f"{name}: only {n_ok}/3 ticks succeeded"
    assert state.get("x") > 0.1, f"{name}: no progress (x={state.get('x')})"
