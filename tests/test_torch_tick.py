"""The single-robot planner tick of the port (Planner, Solver, TMPCOptimizer)
against the JAX package's, on the CPU at f64.

1. Lockstep: a JAX and a port planner run the same closed loop. Each tick
   the test intercepts both optimizers' ``_dispatch_batch``/``_fetch_batch``
   (on the test's objects), checks that the dispatched params, xinit and warm
   starts agree to 1e-12, solves them once with the port's plain fused
   solver and hands the same result to both selection halves. Everything the
   host does must then agree exactly: selection, topology bookkeeping, the
   solver's output and parameters, the consistency trajectory. One tick has
   every planner infeasible, one has every planner returning the same
   solution (ties).
2. One real tick each, at a converged schedule: JAX's ``"xla"`` solve
   against the port's ``"fused"`` one (its plain version on the CPU).
3. The port alone: split against serial ticks, a 28-tick pipelined closed
   loop, the buffered packed solve, the backend rule, the iteration ladder.
"""

import inspect
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as j_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as j_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as j_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as j_dp)
from oscar_mpc_planner_mr_modification_tpu.sim import pedestrians as j_ped  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.solver import State as JState  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_settings)
from oscar_mpc_planner_mr_modification_tpu_torch import factory as t_factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import types as t_types  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    EllipsoidConstraintModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as t_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.planner import (  # noqa: E402
    data_preparation as t_dp)
from oscar_mpc_planner_mr_modification_tpu_torch.sim import (  # noqa: E402
    pedestrians as t_ped)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import (  # noqa: E402
    Solver as TSolver, State as TState)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_settings)

DT = 0.2
F64 = torch.float64
#: The bench's operating point (schedule 1x3+1x5+2x8, Gershgorin, last
#: iterate), at f64.
BENCH = dict(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
             regularization="gershgorin", track_best=False,
             qp_iter_schedule=((1, 3), (1, 5), (2, 8)))
#: The converged schedule of the real-tick comparison.
CONVERGED = dict(n_sqp=8, n_qp_iter=20, regularization="gershgorin",
                 track_best=False)
#: Pedestrians crossing the path: (start, goal).
CROSSING = [((4.0, 2.5), (4.0, -3.0)), ((7.0, -2.5), (7.0, 3.0)),
            ((10.0, 2.0), (10.0, -3.0))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain solves run many tiny tensor ops: one intra-op thread runs
    them faster than several, and the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _overrides(road, seed):
    return dict(guidance={"n_samples": 40, "longitudinal_goals": 2,
                          "vertical_goals": 3, "seed": seed},
                contouring={"add_road_constraints": road})


class Side:
    """One package's planner, state, pedestrians and data builder."""

    def __init__(self, pkg, N, config, clock, road=True, pedestrians=True,
                 seed=1):
        factory, settings_fn, self.dp, self.types, ped, state_cls, sqp = pkg
        self.N = N
        self.settings = settings_fn(N=N, max_obstacles=2,
                                    **_overrides(road, seed))
        self.model, modules = factory.configuration_tmpc_consistency_cost(
            self.settings)
        kw = (dict(dtype=jnp.float64) if factory is j_factory
              else dict(dtype=F64, device="cpu"))
        self.planner = factory.build_planner(
            self.model, modules, self.settings,
            sqp_config=sqp.SQPConfig(**config), clock=clock, **kw)
        self.opt = next(m for m in self.planner.modules
                        if hasattr(m, "_optimizer"))._optimizer
        self.state = state_cls(self.model)
        self.state.set("v", 0.5)
        self.sim = (ped.PedestrianSimulator(
            [ped.Pedestrian(np.array(s), np.array(g), desired_speed=0.8)
             for s, g in CROSSING], dt=DT) if pedestrians else None)
        self.data = self.build_data(self.state)
        self.planner.on_data_received(self.data, "reference_path")

    def build_data(self, st):
        d = self.types.RealTimeData()
        d.robot_area = self.dp.define_robot_area(
            self.settings["robot"]["length"], self.settings["robot"]["width"],
            self.settings["n_discs"])
        d.reference_path.x = list(np.linspace(0.0, 25.0, 30))
        d.reference_path.y = [0.0] * 30
        if self.sim is not None:
            obs = self.sim.get_obstacles(self.N)
        else:
            obs = [self.types.DynamicObstacle(
                index=0, position=np.array([4.0, 0.0]), radius=0.35)]
            obs[0].prediction = self.dp.get_constant_velocity_prediction(
                np.array([4.0, 0.0]), np.zeros(2), DT, self.N)
        d.dynamic_obstacles = self.dp.ensure_obstacle_size(
            obs, st, self.settings["max_obstacles"], self.N, DT)
        return d

    def tick(self, pipelined):
        """solve_mpc_start (or solve_mpc) and the next tick's data; returns
        the finish callable."""
        if not pipelined:
            self.sim.step([self.state.get_position()])
            nxt = self.build_data(self.state)
            out = self.planner.solve_mpc(self.state, nxt)
            self.data = nxt
            return lambda: out
        self.planner.solve_mpc_start(self.state, self.data)
        pred = self.planner.predicted_next_state(self.state)
        self.sim.step([pred.get_position()])
        nxt = self.build_data(pred)
        self.planner.prepare(pred, nxt)
        self.data = nxt
        return self.planner.solve_mpc_finish


JAX = (j_factory, j_settings, j_dp, j_types, j_ped, JState, j_sqp)
PORT = (t_factory, t_settings, t_dp, t_types, t_ped, TState, t_sqp)


def step_state(model, states, out, solver):
    """Advance every state by the first input of the solution (braking
    after a failed tick), through the port's model."""
    if out.success:
        u = [solver.get_output(0, "a"), solver.get_output(0, "w")]
    else:
        u = [-3.0, 0.0]
    x = model.discrete_dynamics(torch.as_tensor(states[0].as_array()),
                                torch.tensor(u, dtype=F64), DT).numpy()
    for st in states:
        st.set_array(x)


def as_result(cls, res):
    return cls(**res._asdict())


# ---------------------------------------------------------------------------
# 1. Lockstep: host halves exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_lockstep_host_halves_exact(pipelined):
    N = 20
    cj, ct = FakeClock(), FakeClock()
    js = Side(JAX, N, BENCH, cj)
    ts = Side(PORT, N, BENCH, ct)
    plain = sqp_fused.make_fused_fleet_solver(
        ts.planner.solver.ocp, t_sqp.SQPConfig(**BENCH), dtype=F64,
        device="cpu")
    P = ts.opt.n_planners
    INFEASIBLE, TIE = 3, 5
    box = {}

    def t_dispatch(params, xinit, warm):
        box["in"] = (params.copy(), np.asarray(xinit).copy(), warm.copy())

    def t_fetch():
        params, xinit, warm = box["in"]
        res = t_sqp.fetch_results(plain(
            params, torch.as_tensor(xinit)[None].expand(P, -1), warm))
        if box["tick"] == INFEASIBLE:
            res = res._replace(success=np.zeros(P, bool),
                               exit_code=np.zeros(P, int))
        if box["tick"] == TIE:
            res = t_sqp.SQPResult(*(np.repeat(f[:1], P, axis=0) for f in res))
        box["res"] = res
        return res

    def j_dispatch(params, xinit, warm):
        for got, want in zip((params, xinit, warm), box["in"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        box["jax_dispatched"] = True

    def j_fetch():
        assert box.pop("jax_dispatched")
        return as_result(j_sqp.SQPResult, box["res"])

    ts.opt._dispatch_batch, ts.opt._fetch_batch = t_dispatch, t_fetch
    js.opt._dispatch_batch, js.opt._fetch_batch = j_dispatch, j_fetch

    picked = set()
    for tick in range(8):
        box.clear()
        box["tick"] = tick
        finish_t = ts.tick(pipelined)
        finish_j = js.tick(pipelined)
        out_t, out_j = finish_t(), finish_j()
        for f in ("success", "exit_code", "selected_topology_id",
                  "selected_planner_index", "used_guidance", "trajectory_cost",
                  "num_of_guidance_found", "topology_changed",
                  "non_guided_homology_failed", "was_infeasible"):
            assert getattr(out_t, f) == getattr(out_j, f), (tick, f)
        assert out_t.success == (tick != INFEASIBLE)
        assert ts.opt.best_planner_index == js.opt.best_planner_index
        mt, mj = ts.planner.module_data, js.planner.module_data
        for f in ("selected_topology_id", "selected_planner_index",
                  "used_guidance", "trajectory_cost", "selected_was_non_guided",
                  "num_of_guidance_found"):
            assert getattr(mt, f) == getattr(mj, f), (tick, f)
        assert mt.solver_state.name == mj.solver_state.name
        st, sj = ts.planner.solver, js.planner.solver
        np.testing.assert_array_equal(st._output_z, sj._output_z)
        np.testing.assert_array_equal(st.params.data, sj.params.data)
        np.testing.assert_array_equal(ts.opt.last_objectives,
                                      js.opt.last_objectives)
        assert (ts.opt._has_previous_trajectory
                == js.opt._has_previous_trajectory)
        np.testing.assert_array_equal(ts.opt._prev_trajectory,
                                      js.opt._prev_trajectory)
        np.testing.assert_array_equal(ts.opt._interp_prev,
                                      js.opt._interp_prev)
        if out_t.success:
            picked.add(out_t.selected_planner_index)
        np.testing.assert_array_equal(ts.state.as_array(), js.state.as_array())
        step_state(ts.model, (ts.state, js.state), out_t, st)
        for pa, pb in zip(ts.sim.pedestrians, js.sim.pedestrians):
            np.testing.assert_array_equal(pa.position, pb.position)
        cj.t += DT
        ct.t += DT
    assert picked, "no tick selected a planner"


# ---------------------------------------------------------------------------
# 2. One real tick each, converged
# ---------------------------------------------------------------------------
def test_real_tick_against_jax_xla():
    """JAX's vmapped XLA solve against the port's fused solve (its plain
    version on the CPU) from the same state: the selected cost within 1e-6
    relative; the same winner's z within 1e-4, or, where the winners differ
    (guided planners often converge to one trajectory), each side's cost of
    the other's winner within 1e-6 of its own minimum."""
    N = 8
    js = Side(JAX, N, CONVERGED, FakeClock())
    ts = Side(PORT, N, CONVERGED, FakeClock())
    assert js.opt._fleet_backends == ["xla"] and ts.opt.fleet_backend == "fused"
    out_j = js.planner.solve_mpc(js.state, js.data)
    out_t = ts.planner.solve_mpc(ts.state, ts.data)
    assert out_j.success and out_t.success
    cost_j, cost_t = out_j.trajectory_cost, out_t.trajectory_cost
    assert abs(cost_t - cost_j) <= 1e-6 * abs(cost_j)
    bj, bt = js.opt.best_planner_index, ts.opt.best_planner_index
    if bj == bt:
        np.testing.assert_allclose(ts.planner.solver._output_z,
                                   js.planner.solver._output_z, atol=1e-4)
    else:
        for costs, own, other in ((js.opt.last_objectives, bj, bt),
                                  (ts.opt.last_objectives, bt, bj)):
            assert abs(costs[other] - costs[own]) <= 1e-6 * abs(costs[own])


# ---------------------------------------------------------------------------
# 3. The port alone
# ---------------------------------------------------------------------------
def test_split_tick_matches_serial():
    """prepare + solve_mpc_start + solve_mpc_finish with a copy of the actual
    state reproduces solve_mpc bit for bit on the first tick. Later, the
    split path re-anchors the progress with the windowed closest-s search
    while the serial path's first anchor searches the whole path: xinit
    parts by ~1e-6, and the guidance PRM can turn that into another sample
    graph (the JAX package does the same on this scene). So later ticks
    agree within 1e-4 wherever the two picked the same planner with the same
    parameters (its guidance unchanged), and xinit within 1e-5 always."""
    N = 20
    ca, cb = FakeClock(), FakeClock()
    a = Side(PORT, N, BENCH, ca, road=False, pedestrians=False, seed=4)
    b = Side(PORT, N, BENCH, cb, road=False, pedestrians=False, seed=4)
    agreed = 0
    for step in range(4):
        da, db = a.build_data(a.state), b.build_data(b.state)
        out_a = a.planner.solve_mpc(a.state, da)
        pred = TState(b.model)
        pred.set_array(b.state.as_array())
        assert b.planner.prepare(pred, db)
        b.planner.solve_mpc_start(b.state, db)
        out_b = b.planner.solve_mpc_finish()
        assert out_a.success == out_b.success
        np.testing.assert_allclose(a.planner.solver._xinit,
                                   b.planner.solver._xinit, rtol=0, atol=1e-5)
        za = a.planner.solver.get_output_trajectory()
        zb = b.planner.solver.get_output_trajectory()
        same_problem = (
            out_a.selected_planner_index == out_b.selected_planner_index
            and np.abs(a.planner.solver.params.data
                       - b.planner.solver.params.data).max() < 1e-4)
        if step == 0:
            np.testing.assert_array_equal(za, zb)
        elif same_problem:
            np.testing.assert_allclose(za, zb, atol=1e-4)
            agreed += 1
        step_state(a.model, (a.state,), out_a, a.planner.solver)
        step_state(b.model, (b.state,), out_b, b.planner.solver)
        ca.t += DT
        cb.t += DT
    assert agreed >= 2


def test_pipelined_closed_loop_28_ticks():
    """28 pipelined ticks past a static obstacle: solved on >= 20, past
    x = 5, never within 0.6 of the obstacle's centre."""
    N = 20
    clock = FakeClock()
    s = Side(PORT, N, BENCH, clock, pedestrians=False)
    obstacle = np.array([4.0, 0.0])
    min_dist, n_success = np.inf, 0
    for _ in range(28):
        s.planner.solve_mpc_start(s.state, s.data)
        pred = s.planner.predicted_next_state(s.state)
        nxt = s.build_data(pred)
        s.planner.prepare(pred, nxt)
        out = s.planner.solve_mpc_finish()
        n_success += out.success
        step_state(s.model, (s.state,), out, s.planner.solver)
        clock.t += DT
        s.data = nxt
        min_dist = min(min_dist,
                       np.linalg.norm(s.state.get_position() - obstacle))
    assert n_success >= 20, f"solved {n_success}/28"
    assert s.state.get("x") > 5.0, f"did not progress: {s.state}"
    assert min_dist > 0.6, f"too close to obstacle: {min_dist:.2f}"
    assert s.opt.global_guidance.ran_backend == "cpp"


def test_buffered_packed_solve_dispatch_fetch():
    """dispatch + fetch equal the one-shot solve and a direct fetch of the
    solver's result; one solve in flight at a time."""
    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        build_tmpc_fleet, tmpc_bench_ocp)

    ocp, settings = tmpc_bench_ocp(N=8, n_paths=2)
    fleet = t_sqp.make_fleet_sqp_solver(
        ocp, t_sqp.SQPConfig(**BENCH), dtype=F64, device="cpu",
        backend="fused")
    P = 3

    def batched(params, xinit, warm):
        return fleet(params, xinit.expand(P, -1), warm)

    solve = t_sqp.make_buffered_packed_solve(
        batched, P, ocp.N, ocp.npar, ocp.nx, ocp.nvar, F64, device="cpu")
    params, xinit, z_init, _ = build_tmpc_fleet(ocp, settings, 1)
    p, x, z = params[0], xinit[0], z_init[0]
    sync = solve(p, x, z)
    handle = solve.dispatch(p, x, z)
    with pytest.raises(RuntimeError, match="in flight"):
        solve.dispatch(p, x, z)
    np.testing.assert_array_equal(solve.fetch(handle), sync)
    with pytest.raises(RuntimeError, match="not in flight"):
        solve.fetch(handle)
    want = t_sqp.fetch_results(fleet(p, np.repeat(x[None], P, 0), z))
    got = t_sqp.unpack_results(sync, ocp.N + 1, ocp.nvar)
    for f in t_sqp.SQPResult._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.z.shape == (P, ocp.N + 1, ocp.nvar)
    assert got.exit_code.dtype.kind == "i" and got.success.dtype == bool


class GaussianStandIn(EllipsoidConstraintModule):
    """A constraint submodule the fused kernel's header does not cover: a
    subclass of the ellipsoid module under the Gaussian module's name (the
    header matches module types exactly, so it covers neither)."""

    module_name = "GaussianConstraints"


def test_backend_rule():
    """The backend follows the config before any launch: "mirror" ->
    "pallas", otherwise "fused"; an OCP the fused kernel does not cover
    raises when the planner is built."""
    settings = t_settings(N=6, max_obstacles=1)
    for reg, want in (("mirror", "pallas"), ("gershgorin", "fused"),
                      ("levenberg", "fused")):
        model, modules = t_factory.configuration_tmpc_consistency_cost(settings)
        planner = t_factory.build_planner(
            model, modules, settings, dtype=F64, device="cpu",
            sqp_config=t_sqp.SQPConfig(n_sqp=2, n_qp_iter=4,
                                       regularization=reg))
        opt = next(m for m in planner.modules if hasattr(m, "_optimizer"))
        assert opt._optimizer.fleet_backend == want
    model, modules = t_factory.configuration_tmpc_consistency_cost(
        settings, constraint_submodule=GaussianStandIn)
    with pytest.raises(NotImplementedError, match="GaussianStandIn"):
        t_factory.build_planner(
            model, modules, settings, dtype=F64, device="cpu",
            sqp_config=t_sqp.SQPConfig(n_sqp=2, n_qp_iter=4,
                                       regularization="gershgorin"))
    params = inspect.signature(t_factory.build_planner).parameters
    assert params["device"].default == "cuda"


def test_iteration_ladder_under_budget():
    """select_iterations picks the largest ladder entry that fits the
    budget, the full count without one; a ladder entry's first solve does
    not feed the per-iteration time; a tick with a wall-clock budget builds
    and runs the reduced entry."""
    settings = t_settings(N=6, max_obstacles=1)
    model, modules = t_factory.configuration_tmpc_consistency_cost(settings)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp

    solver = TSolver(build_ocp(model, modules, settings), settings, dtype=F64,
                     sqp_config=t_sqp.SQPConfig(n_sqp=8, n_qp_iter=4),
                     device="cpu")
    assert solver._iter_ladder == [8, 4, 2]
    assert solver.select_iterations() == 8  # no timing yet
    solver.note_solve_time(8, 1.0, compile_call=True)
    assert solver._iter_time_ema == 0.0 and solver.last_iterations_run == 8
    solver.note_solve_time(8, 0.08, compile_call=False)
    assert solver._iter_time_ema == pytest.approx(0.01)
    for timeout, want in ((0.0, 8), (1.0, 8), (0.05, 4), (0.03, 2),
                          (0.001, 2)):
        solver.solver_timeout = timeout
        assert solver.select_iterations() == want
    solver.adaptive_iterations = False
    assert solver.select_iterations() == 8
    # The single-instance solve runs the selected entry; its first solve
    # does not feed the per-iteration time.
    assert solver.solve() in (0, 1)
    assert solver.last_iterations_run == 8 and 8 in solver._timed_variants
    assert solver._iter_time_ema == pytest.approx(0.01)

    # Through a planner: a budgeted tick runs the half-count entry.
    clock = FakeClock()
    s = Side(PORT, 8, BENCH, clock, pedestrians=False)
    sv = s.planner.solver
    sv._iter_time_ema = 0.012  # 4 x 12 ms > the 44 ms budget at most
    s.data.planning_start_time = time.monotonic()
    s.planner.solve_mpc(s.state, s.data)
    assert sv.last_iterations_run in (1, 2)
    assert sorted(s.opt._packed_solve) == [sv.last_iterations_run, 4]
    assert sv._iter_time_ema == 0.012  # the entry's first solve: not fed


def test_fused_tables_uploaded_once_and_repeatable():
    """The fused solve's tables and phase list are uploaded once per solver
    and device; repeated solves of one solver are bitwise identical (the
    kernel's code built for the host)."""
    if sqp_fused.host_compiler() is None:
        pytest.skip("no C++ compiler for the host build")
    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        build_tmpc_fleet, tmpc_bench_ocp)

    ocp, settings = tmpc_bench_ocp(N=8, n_paths=2)
    solve = sqp_fused.make_fused_fleet_solver(
        ocp, t_sqp.SQPConfig(**BENCH), dtype=F64, device="cpu")
    params, xinit, z_init, _ = build_tmpc_fleet(ocp, settings, 2)
    args = (params.reshape(-1, *params.shape[2:]),
            np.repeat(xinit, params.shape[1], 0),
            z_init.reshape(-1, *z_init.shape[2:]))
    first = solve.host(*args)
    second = solve.host(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    info = solve.consts.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    itab, rtab, phases = solve.consts(torch.device("cpu"))
    assert phases.tolist() == [1, 3, 1, 5, 2, 8]
    np.testing.assert_array_equal(itab.numpy(), solve.tables.ints)
