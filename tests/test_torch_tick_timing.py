"""The pedestrians' timing of ``bench.py::_e2e_tick``, in both packages.

The serial loop of ``_e2e_tick`` steps the pedestrians before it builds a
tick's data, so the planner sees them one step ahead of the robot; stage k
reads prediction step k-1, so stage 1 meets them where they will be. Its
pipelined loop builds the first tick's data before any step, so every tick
sees them one step older. On that timing the robot of either package, each
with its own solver, ends a tick inside a pedestrian; on the serial loop's
scene (the pipelined split started one step later) neither does.
``chip_smoke.py`` runs both timings on the card and holds only the second
to no contact.

Each case is one closed loop of 16 ticks (the contact comes at tick 13-14)
at f64 on the CPU: JAX's ``"xla"`` solve, the port's ``"fused"`` one (its
plain version on the CPU), at bench.py's operating point and scene.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as j_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as j_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import sim as j_sim  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as j_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as j_dp)
from oscar_mpc_planner_mr_modification_tpu.sim import roadmap as j_road  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.solver import State as JState  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_settings)
from oscar_mpc_planner_mr_modification_tpu_torch import factory as t_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import types as t_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import sim as t_sim  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as t_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.planner import (  # noqa: E402
    data_preparation as t_dp)
from oscar_mpc_planner_mr_modification_tpu_torch.sim import (  # noqa: E402
    roadmap as t_road)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import (  # noqa: E402
    State as TState)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_settings)

DT, N, TICKS = 0.2, 20, 16
#: bench.py:517-522
PEDESTRIANS = [(5.0, 3.0), (9.0, -3.0), (13.0, 2.5), (20.0, 3.0),
               (24.0, -3.0), (28.0, 2.5), (35.0, 3.0), (39.0, -3.0),
               (43.0, 2.5), (50.0, 3.0), (54.0, -3.0), (58.0, 2.5)]
BENCH = dict(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
             regularization="gershgorin", track_best=False,
             qp_iter_schedule=((1, 3), (1, 5), (2, 8)))
JAX = (j_factory, j_settings, j_dp, j_types, j_sim, j_road, JState, j_sqp,
       dict(dtype=jnp.float64))
PORT = (t_factory, t_settings, t_dp, t_types, t_sim, t_road, TState, t_sqp,
        dict(dtype=torch.float64, device="cpu"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def planners():
    """One planner per package, built at its first case (JAX compiles its
    solve once for both timings) and reset before each."""
    return {}


def smallest_clearance(pkg, bench_timing, planners):
    """Pipelined ticks of bench.py's scene; the smallest distance between
    the robot's and a pedestrian's discs after a tick, both at one time."""
    factory, settings_fn, dp, types, sim, road, state_cls, sqp, kw = pkg
    settings = settings_fn(N=N, max_obstacles=3)
    if factory not in planners:
        model, modules = factory.configuration_tmpc_consistency_cost(settings)
        clock = Clock()
        planners[factory] = (model, clock, factory.build_planner(
            model, modules, settings, clock=clock,
            sqp_config=sqp.SQPConfig(**BENCH), **kw))
    model, clock, planner = planners[factory]
    planner.reset()
    clock.t = 0.0
    state = state_cls(model)
    state.set("v", 0.8)
    peds = [sim.Pedestrian(np.array([x0, y0]), np.array([x0, -y0]))
            for x0, y0 in PEDESTRIANS]
    psim = sim.PedestrianSimulator(peds, dt=DT)
    ref = road.straight_path(length=65.0)
    r_robot = float(settings["robot_radius"])

    def build_data(st):
        d = types.RealTimeData()
        d.robot_area = dp.define_robot_area(0.65, 0.65, 1)
        d.reference_path = ref
        d.dynamic_obstacles = dp.ensure_obstacle_size(
            psim.get_obstacles(N), st, settings["max_obstacles"], N, DT)
        return d

    data = build_data(state)
    planner.on_data_received(data, "reference_path")
    if not bench_timing:
        psim.step([state.get_position()])
        data = build_data(state)
    iv = model.state_index("v")
    dynamics = t_factory.ContouringSecondOrderUnicycleModel().discrete_dynamics
    clearance, solved = [], 0
    for _ in range(TICKS):
        planner.solve_mpc_start(state, data)
        world = [p.position.copy() for p in peds]
        pred = planner.predicted_next_state(state)
        psim.step([pred.get_position()])
        if bench_timing:
            world = [p.position.copy() for p in peds]
        data = build_data(pred)
        planner.prepare(pred, data)
        out = planner.solve_mpc_finish()
        solved += bool(out.success)
        u = ([planner.get_solution(0, "a"), planner.get_solution(0, "w")]
             if out.success else [-3.0, 0.0])
        x = dynamics(
            torch.as_tensor(np.asarray(state.as_array(), dtype=float)),
            torch.tensor(u, dtype=torch.float64), DT).numpy()
        x[iv] = max(x[iv], 0.0)
        state.set_array(x)
        clock.t += DT
        clearance.append(min(
            np.linalg.norm(state.get_position() - pos) - r_robot - p.radius
            for p, pos in zip(peds, world)))
    assert solved == TICKS
    return min(clearance)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
@pytest.mark.parametrize("bench_timing", [True, False],
                         ids=["bench_pipelined_timing", "serial_scene"])
def test_contact_follows_the_pedestrians_timing(pkg, bench_timing, planners):
    c = smallest_clearance(pkg, bench_timing, planners)
    if bench_timing:
        assert c < -0.1, c
    else:
        assert c > 0.0, c
