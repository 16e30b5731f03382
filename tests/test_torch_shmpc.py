"""BASELINE config 5 (SH-MPC, the scenario planner on the slack model) in the
port, against the JAX package, on the CPU at f64.

- ``ContouringSecondOrderUnicycleModelWithSlack``: sizes, bounds and RK4
  step against JAX's (rtol 1e-12).
- ``configuration_safe_horizon``'s OCP: nh = 24, m = 40 and the parameter
  layout equal to JAX's; the scenario rows through ``ineq`` against JAX's
  (rtol 1e-12).
- The scenario theory and support selection of ``parallel/scenario.py``
  equal to JAX's: ``posterior_epsilon`` and ``scenario_sample_size`` on a
  grid, ``select_support_halfspaces`` and its batched form (a, b and the
  under-coverage count) on seeded inputs.
- ``ScenarioOptimizer.optimize`` through ``build_planner`` on the JAX
  suite's scene (tests/test_scenario.py: N=15, 2 obstacles, 4 solvers, 32
  samples): the same samples and filled parameters, the same best solver,
  support count and certificate; z within 1e-4 of JAX's, the terms of a
  kernel-algorithm solve against JAX's ``"xla"`` one (ROADMAP Queue C: the
  kernels' interior point freezes a QP at residuals of 1e-5, as
  tests/test_torch_fleet.py and tests/test_torch_tick.py hold it). Then,
  in lockstep, both optimizers are handed the same solve of the same
  parameters: every output equal.
- Kernel B2's header on the slack model, compiled for the host: its
  linearization against ``torch.func`` (rtol 1e-9, atol 1e-10), its lane
  form equal to its serial form, its whole solve against
  ``fused_fleet_reference`` (1e-6 per problem, same success); kernel B1's
  host build at (nx, nu) = (6, 2) against ``ip_solve_reference`` (1e-8
  (1 + max|ref|)); ``check_instantiated(6, 2)`` passes.
- The backend rule of the scenario optimizer and ``prewarm_planner``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as jfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import models as jmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import solver as jsolver  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as jtypes  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    scenario as jscen)
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as jdp)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_settings)
from oscar_mpc_planner_mr_modification_tpu_torch import factory as tfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import models as tmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import solver as tsolver  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import types as ttypes  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    ContouringModule, ModuleManager, MPCBaseModule, ScenarioConstraintModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    scenario as tscen)
from oscar_mpc_planner_mr_modification_tpu_torch.planner import (  # noqa: E402
    data_preparation as tdp)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_settings)

F64 = torch.float64
N_SH, DT = 15, 0.2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def shmpc_ocp(pkg, N=6):
    factory, solver, settings_fn = {
        "jax": (jfactory, jsolver, j_settings),
        "torch": (tfactory, tsolver, t_settings)}[pkg]
    settings = settings_fn(N=N)
    return solver.build_ocp(*factory.configuration_safe_horizon(settings),
                            settings)


def random_problems(ocp, B, seed):
    """B problems of the SH-MPC OCP (tools/bench_matrix.py's weights, a
    straight path): P (B, T, npar) with stage N repeating N-1, x0, Z; every
    disc row a random halfspace 0.5-2 m from the iterate, slack 0-0.5."""
    rng = np.random.default_rng(seed)
    T, idx, nu = ocp.N + 1, ocp.registry.save_map(), ocp.nu
    P = np.zeros((B, T, ocp.npar))
    for name, value in (("acceleration", 0.34), ("angular_velocity", 0.85),
                        ("contour", 0.05), ("lag", 0.75), ("velocity", 0.55),
                        ("reference_velocity", 1.0), ("slack", 1e4),
                        ("terminal_angle", 100.0),
                        ("terminal_contouring", 10.0)):
        P[..., idx[name]] = value * rng.uniform(0.5, 1.5, (B, 1))
    for i in range(5):
        P[..., idx[f"spline_x{i}_c"]] = 1.0
        P[..., idx[f"spline_x{i}_d"]] = 5.0 * i
        P[..., idx[f"spline{i}_start"]] = 5.0 * i
    Z = np.zeros((B, T, ocp.nvar))
    Z[..., nu] = np.linspace(0.0, 3.0, T) + rng.normal(0, 0.1, (B, T))
    Z[..., nu + 1] = rng.normal(0, 0.3, (B, T))
    Z[..., nu + 2] = rng.normal(0, 0.2, (B, T))
    Z[..., nu + 3] = rng.uniform(0.5, 1.5, (B, T))
    Z[..., nu + 4] = Z[..., nu]
    Z[..., nu + 5] = rng.uniform(0.0, 0.5, (B, T))
    Z[..., :nu] = rng.normal(0, 0.3, (B, T, nu))
    P[..., idx["ego_disc_0_offset"]] = 0.1
    ang = rng.uniform(0, 2 * np.pi, (B, T, 24))
    a1, a2 = np.cos(ang), np.sin(ang)
    for i in range(24):
        P[..., idx[f"disc_0_scenario_constraint_{i}_a1"]] = a1[..., i]
        P[..., idx[f"disc_0_scenario_constraint_{i}_a2"]] = a2[..., i]
        P[..., idx[f"disc_0_scenario_constraint_{i}_b"]] = (
            a1[..., i] * Z[..., nu] + a2[..., i] * Z[..., nu + 1]
            + rng.uniform(0.5, 2.0, (B, T)))
    P[:, -1] = P[:, -2]
    x0 = Z[:, 0, nu:] + rng.normal(0, 0.01, (B, ocp.nx))
    return tuple(torch.as_tensor(a) for a in (P, x0, Z))


# ---------------------------------------------------------------------------
# Model, OCP, rows
# ---------------------------------------------------------------------------
def test_slack_dynamics_match_jax():
    rng = np.random.default_rng(0)
    jm = jmodels.ContouringSecondOrderUnicycleModelWithSlack()
    tm = tmodels.ContouringSecondOrderUnicycleModelWithSlack()
    assert (tm.nx, tm.nu, tm.states, tm.inputs) == (jm.nx, jm.nu, jm.states,
                                                    jm.inputs)
    assert tm.lower_bound == jm.lower_bound
    assert tm.upper_bound == jm.upper_bound
    assert tm.get_bounds("slack")[:2] == (0.0, 5000.0)
    for _ in range(5):
        x = rng.normal(size=6) * np.array([3.0, 3.0, 2.0, 1.0, 3.0, 0.5])
        u = rng.normal(size=2)
        want = np.asarray(jm.discrete_dynamics(jnp.asarray(x), jnp.asarray(u),
                                               0.2))
        got = tm.discrete_dynamics(torch.as_tensor(x), torch.as_tensor(u),
                                   0.2).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
        assert got[5] == x[5]  # slack does not move


def test_shmpc_ocp_and_rows_match_jax():
    from torch.func import vmap

    jo, to = shmpc_ocp("jax"), shmpc_ocp("torch")
    assert (to.nx, to.nu, to.nh, to.npar) == (jo.nx, jo.nu, jo.nh, jo.npar)
    assert (to.nh, len(to.ineq_row_spec())) == (24, 40)
    assert to.registry.save_map() == jo.registry.save_map()
    assert list(to.ineq_row_spec()) == list(jo.ineq_row_spec())
    for name in ("lh", "uh", "lbz", "ubz"):
        np.testing.assert_array_equal(np.asarray(getattr(to, name)),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    P, _, Z = random_problems(to, 3, seed=1)
    Pf, Zf = P.reshape(-1, to.npar).numpy(), Z.reshape(-1, to.nvar).numpy()
    want = np.asarray(jax.vmap(jo.ineq)(jnp.asarray(Zf), jnp.asarray(Pf)))
    got = vmap(to.ineq)(torch.as_tensor(Zf), torch.as_tensor(Pf)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    want = np.asarray(jax.vmap(jo.cost_stage)(jnp.asarray(Zf),
                                              jnp.asarray(Pf)))
    got = vmap(to.cost_stage)(torch.as_tensor(Zf),
                              torch.as_tensor(Pf)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Scenario theory and support selection
# ---------------------------------------------------------------------------
def test_scenario_theory_matches_jax():
    for S in (20, 32, 128, 1000):
        for k in (0, 1, 5, 10, 19, S):
            assert (tscen.posterior_epsilon(S, k, 1e-2)
                    == jscen.posterior_epsilon(S, k, 1e-2))
    for eps in (0.05, 0.1, 0.3):
        for beta in (1e-3, 1e-2):
            for support in (1, 5, 10, 24):
                assert (tscen.scenario_sample_size(eps, beta, support)
                        == jscen.scenario_sample_size(eps, beta, support))


def test_support_selection_matches_jax():
    rng = np.random.default_rng(3)
    for trial in range(6):
        M = [0, 5, 40][trial % 3]
        pos = rng.normal(size=2)
        centers = pos + rng.normal(0, 2.0, (M, 2))
        margins = rng.uniform(0.3, 0.7, M)
        n_rows = 4 if trial < 3 else 24
        want = jscen.select_support_halfspaces(pos, centers.copy(), margins,
                                               n_rows)
        got = tscen.select_support_halfspaces(pos, centers.copy(), margins,
                                              n_rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pos = rng.normal(size=(3, 5, 1, 2))
    centers = rng.normal(0, 2.0, (3, 5, 1, 60, 2))
    margins = rng.uniform(0.3, 0.7, 60)
    for n_rows in (3, 24):
        want = jscen.select_support_halfspaces_batch(pos, centers, margins,
                                                     n_rows)
        got = tscen.select_support_halfspaces_batch(pos, centers, margins,
                                                    n_rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert got[3].max() == 0 and want[3].max() == 0
    assert jscen.select_support_halfspaces_batch(
        pos, centers, margins, 3)[3].max() > 0  # under-covered at 3 rows


# ---------------------------------------------------------------------------
# The scenario optimizer through the planner
# ---------------------------------------------------------------------------
class Side:
    """One package's SH-MPC planner on the JAX suite's scene (4 parallel
    solvers, 32 samples, risk 0.1, n_sqp 6 x 12, f64)."""

    def __init__(self, pkg):
        j = pkg == "jax"
        factory, settings_fn, types, dp, solver = (
            (jfactory, j_settings, jtypes, jdp, jsolver) if j else
            (tfactory, t_settings, ttypes, tdp, tsolver))
        self.settings = settings_fn(
            N=N_SH, max_obstacles=2,
            probabilistic={"enable": True, "risk": 0.1},
            scenario_constraints={"parallel_solvers": 4, "n_samples": 32})
        model, modules = factory.configuration_safe_horizon(self.settings)
        cfg = (jsqp if j else tsqp).SQPConfig(n_sqp=6, n_qp_iter=12)
        self.planner = factory.build_planner(
            model, modules, self.settings,
            dtype=jnp.float64 if j else F64, sqp_config=cfg,
            **({} if j else {"device": "cpu"}))
        self.opt = next(m for m in self.planner.modules
                        if type(m).__name__ == "ScenarioConstraintModule"
                        )._optimizer
        self.state = solver.State(model)
        self.state.set("v", 0.8)
        data = types.RealTimeData()
        data.robot_area = dp.define_robot_area(0.65, 0.65, 1)
        data.reference_path.x = list(np.linspace(0.0, 20.0, 25))
        data.reference_path.y = [0.0] * 25
        obstacles = []
        for i, pos in enumerate([np.array([4.0, 0.8]),
                                 np.array([6.0, -0.8])]):
            obs = types.DynamicObstacle(index=i, position=pos, radius=0.3)
            obs.prediction = dp.get_constant_velocity_prediction(
                pos, np.array([-0.3, 0.0]), DT, N_SH, probabilistic=True)
            obstacles.append(obs)
        data.dynamic_obstacles = dp.ensure_obstacle_size(
            obstacles, self.state, 2, N_SH, DT, probabilistic=True)
        self.data = data
        self.planner.on_data_received(data, "reference_path")

    def tick(self):
        self.planner.on_data_received(self.data, "dynamic obstacles")
        samples = self.opt._samples.copy()
        return self.planner.solve_mpc(self.state, self.data), samples


@pytest.fixture(scope="module")
def sh_pair():
    return Side("jax"), Side("torch")


def _outputs(side, out):
    return (out.success, side.opt.best_solver_index, side.opt.last_support,
            side.opt.last_certificate, side.opt.last_uncovered)


def test_scenario_optimizer_matches_jax(sh_pair):
    js, ts = sh_pair
    assert ts.opt.fleet_backend == "lanes"  # "mirror", the config default
    assert ts.opt.n_samples == js.opt.n_samples == 32
    out_j, samples_j = js.tick()
    out_t, samples_t = ts.tick()
    np.testing.assert_array_equal(samples_t, samples_j)
    np.testing.assert_array_equal(ts.planner.solver.params.data,
                                  js.planner.solver.params.data)
    assert out_t.success and out_j.success
    assert _outputs(ts, out_t) == _outputs(js, out_j)
    np.testing.assert_allclose(ts.planner.solver._output_z,
                               js.planner.solver._output_z, rtol=0,
                               atol=1e-4)
    assert abs(out_t.trajectory_cost - out_j.trajectory_cost) <= (
        1e-6 * abs(out_j.trajectory_cost))
    slack = [ts.planner.solver.get_output(k, "slack") for k in range(1, N_SH)]
    assert max(slack) < 1.0
    assert 0.0 < ts.opt.last_certificate < 1.0


def test_scenario_selection_lockstep(sh_pair, monkeypatch):
    """From the same previous solution, both optimizers get the port's
    solve of the same parameters: the samples, the fill, the winner, its
    support and certificate, and the solver's output are then equal,
    exactly."""
    js, ts = sh_pair
    solved = {}
    port_solve = ts.opt._solve_batch

    def port_side(params, xinit, warm):
        solved["in"] = (params.copy(), np.asarray(xinit).copy(), warm.copy())
        solved["out"] = port_solve(params, xinit, warm)
        return solved["out"]

    def jax_side(params, xinit, warm):
        for a, b in zip((params, xinit, warm), solved["in"]):
            np.testing.assert_array_equal(np.asarray(a), b)
        return jsqp.SQPResult(*solved["out"])

    monkeypatch.setattr(ts.opt, "_solve_batch", port_side)
    monkeypatch.setattr(js.opt, "_solve_batch", jax_side)
    # both warm-start from the same previous solution
    ts.planner.solver._output_z = js.planner.solver._output_z.copy()
    ts.state.set("v", 1.0)
    js.state.set("v", 1.0)
    out_t, samples_t = ts.tick()
    out_j, samples_j = js.tick()
    np.testing.assert_array_equal(samples_t, samples_j)
    assert _outputs(ts, out_t) == _outputs(js, out_j)
    np.testing.assert_array_equal(ts.planner.solver._output_z,
                                  js.planner.solver._output_z)
    np.testing.assert_array_equal(ts.planner.solver.params.data,
                                  js.planner.solver.params.data)
    assert out_t.trajectory_cost == out_j.trajectory_cost


def test_backend_rule_and_prewarm():
    """The fleet backend follows the config when the planner is built:
    "gershgorin" -> "fused" (B2, its plain version on the CPU), "mirror" ->
    "lanes" (the mirror linearize entry and B1 per SQP iteration), "mirror"
    with warm duals -> "pallas"; an OCP the fused kernel does not cover
    raises then; prewarm_planner runs a tick and resets."""
    settings = t_settings(N=6, max_obstacles=2,
                          probabilistic={"enable": True, "risk": 0.1},
                          scenario_constraints={"parallel_solvers": 2,
                                                "n_samples": 8})
    for reg, warm, want in (("gershgorin", 0, "fused"),
                            ("mirror", 0, "lanes"), ("mirror", 3, "pallas")):
        model, modules = tfactory.configuration_safe_horizon(settings)
        planner = tfactory.build_planner(
            model, modules, settings, dtype=F64, device="cpu",
            sqp_config=tsqp.SQPConfig(n_sqp=2, n_qp_iter=6,
                                      n_qp_iter_warm=warm,
                                      regularization=reg))
        opt = next(m for m in planner.modules
                   if isinstance(m, ScenarioConstraintModule))._optimizer
        assert opt.fleet_backend == want
        tfactory.prewarm_planner(planner, model, settings)
        assert opt._samples is None and opt.best_solver_index >= 0
    # scenario rows on a model without a slack state: not covered
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(ContouringModule(settings))
    scen = mm.add_module(ScenarioConstraintModule(settings))
    scen.use_slack = False
    ocp = tsolver.build_ocp(tmodels.ContouringSecondOrderUnicycleModel(), mm,
                            settings)
    with pytest.raises(NotImplementedError, match="slack"):
        sqp_fused.ocp_tables(ocp, tsqp.SQPConfig(regularization="gershgorin"))


# ---------------------------------------------------------------------------
# Kernels B2 and B1 on the slack model (host builds)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reg", ["gershgorin", "levenberg"])
def test_header_linearization_matches_torch_func(host, reg):
    ocp = shmpc_ocp("torch", N=8)
    cfg = tsqp.SQPConfig(regularization=reg, reg_eps=1e-4, levenberg=2e-3)
    tables = sqp_fused.ocp_tables(ocp, cfg)
    assert (tables.model, tables.nx, tables.nu, tables.m, tables.mh) == (
        2, 6, 2, 40, 24)
    assert tables.ints[sqp_fused.TB_SLACK] == ocp.registry.index("slack")
    mach = tsqp._make_machinery(ocp, cfg, F64, "cpu")
    P, x0, Z = random_problems(ocp, 4, seed=21)
    got = sqp_fused.host_linearize(tables, P, x0, Z)
    lanes = sqp_fused.host_linearize(tables, P, x0, Z, lanes=True)
    want = sqp_fused.linearize_reference(mach, tables, P, x0, Z)
    for name, a, b in zip(sqp_fused.QPData._fields, got[0], want[0]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for name, a, b in zip(sqp_fused.QPData._fields + ("merit", "cost",
                                                      "eq_res"),
                          (*lanes[0], *lanes[1:]), (*got[0], *got[1:])):
        assert torch.equal(a, b), name
    # each scenario row reads x, y, psi (disc offset 0.1) and slack
    D = got[0].D[:, :-1]
    rows = [r for r, (k, _) in enumerate(ocp.ineq_row_spec()) if k == "hu"]
    assert (D[:, :, rows][..., [2, 3, 4, 7]].abs() > 0).all()
    assert (D[:, :, rows][..., 7] == 1.0).all()


@pytest.mark.parametrize("track_best", [False, True])
def test_header_solve_matches_fused_fleet_reference(host, track_best):
    ocp = shmpc_ocp("torch", N=8)
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=10, mu_min=1e-6, w_max=1e6,
                         reg_eps=1e-4, regularization="gershgorin",
                         track_best=track_best,
                         qp_iter_schedule=((2, 6), (2, 10)))
    solve = tsqp.make_fleet_sqp_solver(ocp, cfg, dtype=F64, device="cpu",
                                       backend="fused")
    P, x0, Z = random_problems(ocp, 4, seed=22)
    launches = sqp_fused.launches
    got = solve.host(P[:, :-1], x0, Z)
    assert sqp_fused.launches == launches
    want = solve(P[:, :-1], x0, Z)
    assert bool((got.success == want.success).all())
    assert bool(want.success.any())
    rel = ((got.z - want.z).abs().amax(dim=(1, 2))
           / (1.0 + want.z.abs().amax(dim=(1, 2))))
    assert rel.max().item() <= 1e-6
    np.testing.assert_allclose(got.cost.numpy(), want.cost.numpy(),
                               rtol=1e-6, atol=1e-9)


def test_qp_host_build_at_6_2_matches_plain(host):
    ocp = shmpc_ocp("torch", N=8)
    cfg = tsqp.SQPConfig(regularization="gershgorin", reg_eps=1e-4)
    mach = tsqp._make_machinery(ocp, cfg, F64, "cpu")
    P, x0, Z = random_problems(ocp, 4, seed=23)
    qp = mach.build_qp(Z, P, x0)
    assert qp.A.shape[-1] == 6 and qp.B.shape[-1] == 2 and qp.D.shape[2] == 40
    kw = dict(nu=2, n_iters=15, mu_min=1e-6, w_max=1e6,
              row_meta=mach.row_meta)
    rows = qp_cuda._rows(mach.stage_mask, mach.row_meta, qp.g.shape[1],
                         qp.D.shape[2])
    fields = qp_cuda._batch_fields(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                                   qp.r0, rows)
    z = qp_cuda.host_solve_qp_fields(fields, mach.stage_mask, **kw)
    want = qp_cuda.ip_solve_reference(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D,
                                      qp.e, mach.stage_mask, qp.r0, **kw)
    want = want.reshape(want.shape[0], -1).t()
    assert z.shape == want.shape and torch.isfinite(z).all()
    err = (z - want).abs().max().item()
    assert err <= 1e-8 * (1.0 + want.abs().max().item()), err
    qp_cuda.check_instantiated(6, 2)
