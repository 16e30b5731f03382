"""``Solver.solve`` of the port: the single-instance solve behind a planner
whose modules do not claim the optimization (``configuration_basic``),
against the JAX package's, on the CPU at f64.

- Lockstep closed loop: tests/test_planner.py::
  test_contouring_follows_curved_path's scene (N=15, the 8 m arc, a
  6 x 12 SQP), with two obstacles beside the arc, 4 ticks. Both planners
  see the same state each tick; their solver outputs agree within atol
  1e-6, their objectives within rtol 1e-8, their last QP's
  complementarity (``info["qp_comp"]``) within rtol 1e-3 (a value near the
  QP's mu_min, where round-off is amplified), the exit codes exactly.
- The methods the port's Solver gained: ``explain_exit_flag``,
  ``print_if_bound_limited``, ``copy_params_from`` and ``_ladder_fn``, each
  against JAX's.
- The budget ladder (mirror of tests/test_planner.py::
  test_budget_adaptive_iteration_control on the contouring OCP).
- ``TMPCOptimizer._solve_batch`` against its dispatch and fetch halves.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as j_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as j_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as j_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.planner import Planner as JPlanner  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as j_dp)
from oscar_mpc_planner_mr_modification_tpu.sim import roadmap as j_road  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    Solver as JSolver, State as JState, build_ocp as j_build_ocp)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_settings)
from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as t_bench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import factory as t_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import types as t_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as t_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.planner import (  # noqa: E402
    data_preparation as t_dp)
from oscar_mpc_planner_mr_modification_tpu_torch.sim import roadmap as t_road  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPResult)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import (  # noqa: E402
    State as TState)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_settings)

F64 = torch.float64
N, DT = 15, 0.2
#: Two static obstacles beside the 8 m arc (centre at (0, 8)).
OBSTACLES = [(2.6, 0.9), (5.0, 2.4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_data(pkg_types, dp, settings, state, path):
    data = pkg_types.RealTimeData()
    data.robot_area = dp.define_robot_area(
        settings["robot"]["length"], settings["robot"]["width"],
        settings["n_discs"])
    obstacles = []
    for i, pos in enumerate(OBSTACLES):
        obs = pkg_types.DynamicObstacle(index=i, position=np.asarray(pos),
                                        radius=0.3)
        obs.prediction = dp.get_constant_velocity_prediction(
            np.asarray(pos), np.zeros(2), DT, N)
        obstacles.append(obs)
    data.dynamic_obstacles = dp.ensure_obstacle_size(
        obstacles, state, settings["max_obstacles"], N, DT)
    data.reference_path = path
    return data


class Side:
    """One package's configuration_basic planner on the arc."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        if jax_side:
            settings = j_settings(N=N, max_obstacles=2)
            model, mm = j_factory.configuration_basic(settings)
            ocp = j_build_ocp(model, mm, settings)
            self.solver = JSolver(ocp, settings, dtype=jnp.float64,
                                  sqp_config=j_sqp.SQPConfig(n_sqp=6,
                                                             n_qp_iter=12))
            self.planner = JPlanner(self.solver, mm, settings)
            self.path = j_road.curve_path(radius=8.0, angle=np.pi / 2,
                                          n_points=10)
            self.state = JState(model)
            self.types, self.dp = j_types, j_dp
        else:
            settings = t_settings(N=N, max_obstacles=2)
            model, mm = t_factory.configuration_basic(settings)
            self.planner = t_factory.build_planner(
                model, mm, settings, dtype=F64, device="cpu",
                sqp_config=t_sqp.SQPConfig(n_sqp=6, n_qp_iter=12))
            self.solver = self.planner.solver
            self.path = t_road.curve_path(radius=8.0, angle=np.pi / 2,
                                          n_points=10)
            self.state = TState(model)
            self.types, self.dp = t_types, t_dp
        self.settings, self.model = settings, model

    def tick(self, x, first):
        self.state.set_array(np.asarray(x, dtype=float))
        data = make_data(self.types, self.dp, self.settings, self.state,
                         self.path)
        if first:
            self.planner.on_data_received(data, "reference_path")
        out = self.planner.solve_mpc(self.state, data)
        return out


@pytest.fixture(scope="module")
def lockstep():
    """Both planners over 4 ticks from the same states (the JAX side's
    closed loop); per tick both outputs."""
    sides = Side(True), Side(False)
    jside = sides[0]
    jside.state.set("x", jside.path.x[0])
    jside.state.set("y", jside.path.y[0])
    jside.state.set("psi", jside.path.psi[0])
    jside.state.set("v", 1.0)
    x = jside.state.as_array().copy()
    ticks = []
    for step in range(4):
        rec = []
        for side in sides:
            out = side.tick(x, step == 0)
            rec.append(dict(
                success=out.success, exit_code=out.exit_code,
                z=side.solver.get_output_trajectory(),
                info=dict(side.solver.info),
                a=side.planner.get_solution(0, "a"),
                w=side.planner.get_solution(0, "w"),
                iters=side.solver.last_iterations_run))
        ticks.append(rec)
        j = rec[0]
        x = np.asarray(jside.model.discrete_dynamics(
            jnp.asarray(x), jnp.asarray([j["a"], j["w"]]), DT))
    return sides, ticks


def test_closed_loop_matches_jax_planner(lockstep):
    sides, ticks = lockstep
    for k, (j, t) in enumerate(ticks):
        assert j["success"] and t["success"], k
        assert t["exit_code"] == j["exit_code"] == 1
        assert t["iters"] == j["iters"] == 6
        np.testing.assert_allclose(t["z"], j["z"], rtol=0, atol=1e-6,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(t["info"]["pobj"], j["info"]["pobj"],
                                   rtol=1e-8)
        np.testing.assert_allclose(t["info"]["eq_res"], j["info"]["eq_res"],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(t["info"]["qp_comp"], j["info"]["qp_comp"],
                                   rtol=1e-3)
        assert t["info"]["qp_comp"] > 0.0
    # the loop moved along the arc and stayed clear of the obstacles
    z = ticks[-1][1]["z"]
    assert z[0, 2] > 0.5
    nu = sides[1].solver.nu
    for ox, oy in OBSTACLES:
        assert np.hypot(z[:, nu] - ox, z[:, nu + 1] - oy).min() > 0.6
    # The solver's tensors live on the CPU, as asked.
    assert sides[1].solver.device.type == "cpu"


def test_exit_flags_and_bound_report_match_jax(lockstep):
    sides, _ = lockstep
    jsv, tsv = sides[0].solver, sides[1].solver
    for code in (None, 0, 1, 2, 3, 7):
        assert tsv.explain_exit_flag(code) == jsv.explain_exit_flag(code)
    # a result that sits on bounds: a = -2 (lower) at stage 1, w = 0.8
    # (upper) at stage 3, v = 3.0 (upper) at stage 0 (a state at stage 0:
    # not reported)
    z = tsv.get_output_trajectory()
    z[1, 0], z[3, 1] = -2.0, 0.8
    z[0, tsv.nu + 3] = 3.0
    res = SQPResult(z=z, cost=1.0, eq_res=0.0, qp_comp=0.0, success=True,
                    exit_code=1)
    for sv in (jsv, tsv):
        sv.load_result(res)
    hits = tsv.print_if_bound_limited()
    assert hits == jsv.print_if_bound_limited()
    assert (1, "a", "lower") in hits and (3, "w", "upper") in hits
    assert not any(k == 0 and name == "v" for k, name, _ in hits)


def test_copy_params_from_and_ladder_fn_match_jax(lockstep):
    sides, _ = lockstep
    for side in sides:
        sv = side.solver
        other = sv.clone()
        other.params.data[...] = 7.0
        other._x0[...] = 3.0
        other._output_z[...] = 5.0
        sv2 = sv.clone()
        sv2.copy_params_from(other)
        np.testing.assert_array_equal(sv2.params.data, other.params.data)
        np.testing.assert_array_equal(sv2._x0, other._x0)
        assert sv2.params.data is not other.params.data
        assert sv2._x0 is not other._x0
        assert not np.array_equal(sv2._output_z, other._output_z)
        # the ladder's solves are shared between clones, and built once
        assert sv2._ladder_fns is sv._ladder_fns
        assert sv2._timed_variants is sv._timed_variants
        assert sv._ladder_fn(6) is sv._solve_fn
        fn3 = sv._ladder_fn(3)
        assert sv2._ladder_fn(3) is fn3
    assert sides[1].solver._iter_ladder == sides[0].solver._iter_ladder
    assert set(sides[1].solver._ladder_fns) == set(sides[0].solver._ladder_fns)


def test_budget_ladder():
    """The solve runs fewer SQP iterations when the tick's budget is nearly
    spent, and still emits a usable command."""
    settings = t_settings(N=10, max_obstacles=2)
    model, mm = t_factory.configuration_basic(settings)
    planner = t_factory.build_planner(
        model, mm, settings, dtype=F64, device="cpu",
        sqp_config=t_sqp.SQPConfig(n_sqp=8, n_qp_iter=15))
    solver = planner.solver
    assert solver.adaptive_iterations
    assert solver._iter_ladder == [8, 4, 2]

    solver._iter_time_ema = 0.004
    solver.solver_timeout = 0.050
    assert solver.select_iterations() == 8
    solver.solver_timeout = 0.020
    assert solver.select_iterations() == 4
    solver.solver_timeout = 0.009
    assert solver.select_iterations() == 2
    solver.solver_timeout = 0.0
    assert solver.select_iterations() == 8
    solver._iter_time_ema = 0.0
    solver.solver_timeout = 0.020
    assert solver.select_iterations() == 8

    state = TState(model)
    state.set("v", 0.5)
    path = t_road.straight_path(length=30.0)
    data = make_data(t_types, t_dp, settings, state, path)
    planner.on_data_received(data, "reference_path")
    out = planner.solve_mpc(state, data)
    assert out.success and solver.last_iterations_run == 8
    assert solver._iter_time_ema == 0.0  # the entry's first solve: not fed
    # A late tick: ~14 ms of the 50 ms budget left -> the 2-iteration entry
    solver._iter_time_ema = 0.004
    data.planning_start_time = time.monotonic() - 0.030
    out = planner.solve_mpc(state, data)
    assert out.success, "the reduced solve must still emit a command"
    assert solver.last_iterations_run == 2
    assert sorted(solver._ladder_fns) == [2, 8]
    assert np.isfinite(planner.get_solution(1, "v"))


def test_solve_batch_is_dispatch_then_fetch():
    ocp, settings = t_bench.tmpc_bench_ocp(N=5, n_paths=2)
    planner = t_factory.build_planner(
        *t_factory.configuration_tmpc_consistency_cost(settings), settings,
        dtype=F64, device="cpu",
        sqp_config=t_sqp.SQPConfig(n_sqp=2, n_qp_iter=4,
                                   regularization="gershgorin"))
    opt = next(m for m in planner.modules
               if hasattr(m, "_optimizer"))._optimizer
    params, xinit, z_init, _ = t_bench.build_tmpc_fleet(
        planner.solver.ocp, settings, 1, seed=2, dtype=np.float64)
    assert params.shape[1] == opt.n_planners
    args = (params[0], xinit[0], z_init[0])
    got = opt._solve_batch(*args)
    opt._dispatch_batch(*args)
    want = opt._fetch_batch()
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert opt._pending_solve is None


def test_configuration_tmpc_matches_jax():
    settings = t_settings(N=6, max_obstacles=1)
    _, modules = t_factory.configuration_tmpc(settings)
    _, jmodules = j_factory.configuration_tmpc(j_settings(N=6,
                                                          max_obstacles=1))
    assert ([type(m).__name__ for m in modules]
            == [type(m).__name__ for m in jmodules])
    assert "ConsistencyModule" not in [type(m).__name__ for m in modules]
