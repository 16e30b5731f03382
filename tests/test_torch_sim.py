"""The port's closed-loop simulation environment (``sim/environment.py``)
on the CPU: one ``SimEnvironment.run_episode`` of the JAX suite's scene
(tests/test_sim.py: a goal_tmpc robot, probabilistic predictions, one
pedestrian crossing) at N=10, with its assertions: the episode completes,
no collision, at least 0.6 m to the pedestrian. The robot's own motion is
integrated on the host in f64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscar_mpc_planner_mr_modification_tpu_torch.factory import (  # noqa: E402
    build_planner, configuration_goal_tmpc)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.sim import (  # noqa: E402
    Pedestrian, PedestrianSimulator, SimEnvironment)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_sim_environment_episode_completes():
    torch.set_num_threads(1)
    clock = FakeClock()
    settings = default_settings(
        N=10, max_obstacles=2, weights={"goal": 5.0},
        probabilistic={"enable": True, "risk": 0.05},
        guidance={"n_samples": 30, "longitudinal_goals": 2,
                  "vertical_goals": 3})
    model, modules = configuration_goal_tmpc(settings)
    planner = build_planner(model, modules, settings, dtype=torch.float64,
                            sqp_config=SQPConfig(n_sqp=5, n_qp_iter=10,
                                                 regularization="gershgorin"),
                            clock=clock, device="cpu")
    peds = [Pedestrian(position=np.array([4.0, 2.5]),
                       goal=np.array([4.0, -4.0]))]
    env = SimEnvironment(planner, model, settings,
                         pedestrian_sim=PedestrianSimulator(peds, dt=0.2),
                         goal=np.array([7.0, 0.5]), clock=clock)
    start = np.zeros(model.nx)
    start[model.state_index("x")] = 1.0
    start[model.state_index("v")] = 0.5
    result = env.run_episode(max_cycles=80, start_state=start)
    assert result.completed, f"episode failed: {result}"
    assert result.collisions == 0
    assert result.min_obstacle_distance > 0.6
    assert result.trajectory.shape == (result.n_cycles, 2)
