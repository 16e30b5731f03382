"""The port's real-vehicle IO adapters (``multirobot/vehicle_io.py``) on the
CPU: the tracked-object obstacle update against the JAX package's on the
same objects (exact), and the port's ``RealVehicleAgent`` closed loop and
braking ramp (the JAX suite's scenes at N=8)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscar_mpc_planner_mr_modification_tpu import multirobot as j_mr  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as j_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as j_dp)
from oscar_mpc_planner_mr_modification_tpu_torch import multirobot as t_mr  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import types as t_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.factory import (  # noqa: E402
    build_planner, configuration_goal_tmpc)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.planner import (  # noqa: E402
    data_preparation as t_dp)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

CFG = dict(regularization="gershgorin")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_update_noncommunicating_obstacles_equal_to_jax():
    """Seeded tracked objects (robots among them, still and moving, any
    yaw) over seeded obstacle stores: the same count, positions, angles and
    predictions in both packages, bit for bit."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.choice(12, size=6, replace=False)
        stores, counts = [], []
        for mr, types_, dp in ((t_mr, t_types, t_dp), (j_mr, j_types, j_dp)):
            data = types_.RealTimeData()
            for idx in ids[:4]:
                obs = types_.DynamicObstacle(index=int(idx),
                                             position=np.zeros(2), radius=0.3)
                obs.prediction = dp.get_constant_velocity_prediction(
                    np.zeros(2), np.zeros(2), 0.2, 10)
                data.dynamic_obstacles.append(obs)
            stores.append(data)
        objs_rng = np.random.default_rng(int(rng.integers(1 << 30)))
        specs = [(int(i), objs_rng.normal(0, 3, 2),
                  float(objs_rng.uniform(-np.pi, np.pi)),
                  objs_rng.normal(0, 1, 2) * (objs_rng.uniform() > 0.3))
                 for i in ids]
        for (mr, data) in ((t_mr, stores[0]), (j_mr, stores[1])):
            objs = [mr.TrackedObject(id=i, position=p, yaw=y,
                                     body_velocity=v) for i, p, y, v in specs]
            counts.append(mr.update_noncommunicating_obstacles(
                data, objs, n_robot_ids=3, dt=0.2, N=10))
        assert counts[0] == counts[1]
        for a, b in zip(stores[0].dynamic_obstacles,
                        stores[1].dynamic_obstacles):
            assert a.index == b.index and a.angle == b.angle
            assert np.array_equal(a.position, b.position)
            pa = [s.position for s in a.prediction.modes[0]]
            pb = [s.position for s in b.prediction.modes[0]]
            assert np.array_equal(pa, pb)


def _planner(clock, N=8, **kw):
    settings = default_settings(
        N=N, max_obstacles=2,
        guidance={"n_samples": 30, "longitudinal_goals": 2,
                  "vertical_goals": 3}, **kw)
    model, modules = configuration_goal_tmpc(settings)
    planner = build_planner(model, modules, settings, dtype=torch.float64,
                            sqp_config=SQPConfig(n_sqp=5, n_qp_iter=10,
                                                 **CFG),
                            clock=clock, device="cpu")
    return planner, model, settings


def test_real_vehicle_agent_closed_loop():
    """The agent reads poses from IO, plans against a tracked object that
    survives each cycle's obstacle rebuild, and pushes finite (v, w)
    commands; the object's predicted velocity is its body twist rotated to
    the global frame."""
    torch.set_num_threads(1)
    clock = FakeClock()
    planner, model, settings = _planner(clock, weights={"goal": 5.0})
    poses = [t_mr.PoseMeasurement(np.array([0.1 * k, 0.0]), 0.0, 0.8,
                                  0.1 * k) for k in range(30)]
    frames = [[t_mr.TrackedObject(id=5, position=np.array([3.0,
                                                           2.0 - 0.1 * k]),
                                  yaw=-np.pi / 2,
                                  body_velocity=np.array([0.5, 0.0]))]
              for k in range(30)]
    io = t_mr.MockViconIO(poses=poses, object_frames=frames)
    agent = t_mr.RealVehicleAgent("jackal_real", 0, planner, model, settings,
                                  goal=np.array([6.0, 0.0]),
                                  bus=t_mr.MessageBus(), clock=clock,
                                  start_pose=(0.0, 0.0, 0.0), io=io,
                                  n_robot_ids=1)
    agent.set_peers(["jackal_real"])
    for _ in range(12):
        agent.tick()
        clock.t += 0.2
    assert agent.fsm == t_types.PlannerState.PLANNING_ACTIVE
    assert len(io.commands) >= 8
    assert all(np.isfinite(v) and np.isfinite(w) for v, w in io.commands)
    assert max(c[0] for c in io.commands) > 0.1
    assert abs(agent.state.get("x") - poses[11].position[0]) < 0.11
    vicon = [o for o in agent.data.dynamic_obstacles if o.index == 5]
    assert vicon
    q0 = vicon[0].prediction.modes[0][0].position
    q1 = vicon[0].prediction.modes[0][1].position
    np.testing.assert_allclose((q1 - q0) / planner.solver.dt, [0.0, -0.5],
                               atol=1e-6)


def test_real_vehicle_agent_brakes_on_missing_plan():
    """Without a goal the planner's data gate fails: the agent pushes the
    braking ramp."""
    clock = FakeClock()
    planner, model, settings = _planner(clock)
    io = t_mr.MockViconIO(poses=[t_mr.PoseMeasurement(np.zeros(2), 0.0, 1.2,
                                                      0.0)])
    agent = t_mr.RealVehicleAgent("r", 0, planner, model, settings,
                                  goal=np.array([5.0, 0.0]),
                                  bus=t_mr.MessageBus(), clock=clock, io=io,
                                  n_robot_ids=1)
    agent.set_peers(["r"])
    agent.data.goal_received = False
    agent.data.goal = None
    for _ in range(5):
        agent.tick()
        clock.t += 0.2
    assert len(io.commands) >= 1
    dec = abs(settings["deceleration_at_infeasible"])
    assert io.commands[-1][0] <= 1.2 - dec * 0.2 + 1e-9
