"""BASELINE config 3 (CC-MPC, Gaussian chance constraints on the contouring
model) in the port, against the JAX package, on the CPU at f64.

- ``utils/math.py::erfinv_newton`` against JAX's (rtol 1e-12) and against
  ``scipy.special.erfinv`` (rtol 1e-12) on a risk grid from 1e-3 to 0.49.
- ``GaussianConstraintModule``'s rows through the OCP's ``ineq`` against
  JAX's on random z and parameters, for ``max_modes`` 1 and 2 and
  ``n_discs`` 1 and 2 (rtol 1e-12); the registry and rows equal JAX's.
- ``set_parameters`` on a two-mode GMM scene (with a static obstacle and an
  absent mode) writes JAX's buffer, exactly.
- Kernel B2's header on the CC-MPC OCP, compiled for the host: its
  linearization against ``torch.func`` (rtol 1e-9, atol 1e-10), its lane
  form equal to its serial form, and its whole solve against
  ``fused_fleet_reference`` (1e-6 per problem, same success).
- ``make_contouring_rollout(constraints="gaussian")``: the first tick's
  parameters bit-equal to JAX's; a short rollout (N=10, B=8, 4 ticks,
  ``backend="xla"`` on both sides, a one-phase schedule, so that JAX
  compiles one program) within atol 1e-6 of JAX's; the backend rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.special import erfinv  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import models as jmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import modules as jmodules  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import solver as jsolver  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as jtypes  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jro)
from oscar_mpc_planner_mr_modification_tpu.planner import (  # noqa: E402
    data_preparation as jdp)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_settings)
from oscar_mpc_planner_mr_modification_tpu.utils.math import (  # noqa: E402
    erfinv_newton as j_erfinv)
from oscar_mpc_planner_mr_modification_tpu_torch import models as tmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import modules as tmodules  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import solver as tsolver  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPConfig, _make_machinery, make_fleet_sqp_solver)
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    rollout as tro)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_settings)
from oscar_mpc_planner_mr_modification_tpu_torch.utils.math import (  # noqa: E402
    erfinv_newton as t_erfinv)

F64 = torch.float64
#: The rollout parity's one-phase schedule (one JAX program).
ROLLOUT_CFG = dict(n_sqp=2, n_qp_iter=10, mu_min=1e-8, w_max=1e8,
                   reg_eps=1e-6, regularization="gershgorin",
                   track_best=False)


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


def ccmpc_ocp(pkg, N=6, n_obstacles=2, modes=1, discs=1):
    """The CC-MPC OCP of tools/bench_matrix.py (MPCBase on a, w and v,
    contouring, Gaussian constraints) in the JAX package (``"jax"``) or the
    port (``"torch"``)."""
    models, modules, solver, settings_fn = {
        "jax": (jmodels, jmodules, jsolver, j_settings),
        "torch": (tmodels, tmodules, tsolver, t_settings)}[pkg]
    settings = settings_fn(N=N, max_obstacles=n_obstacles, n_discs=discs)
    settings["probabilistic"]["max_modes"] = modes
    mm = modules.ModuleManager()
    base = mm.add_module(modules.MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    base.weigh_variable("v", ["velocity", "reference_velocity"],
                        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    mm.add_module(modules.ContouringModule(settings))
    mm.add_module(modules.GaussianConstraintModule(settings))
    return solver.build_ocp(models.ContouringSecondOrderUnicycleModel(), mm,
                            settings)


def random_problems(ocp, B, seed):
    """B problems of a CC-MPC OCP around a realistic point: P (B, T, npar)
    with stage N repeating N-1, x0 (B, nx), Z (B, T, nz); the obstacles 1-3
    m from the iterate, sigmas 0.05-0.4, risks 1e-3-0.45."""
    rng = np.random.default_rng(seed)
    T, idx = ocp.N + 1, ocp.registry.save_map()
    P = np.zeros((B, T, ocp.npar))
    w = t_settings()["weights"]
    for name in ("acceleration", "angular_velocity", "velocity",
                 "reference_velocity", "contour", "lag", "terminal_angle",
                 "terminal_contouring"):
        P[..., idx[name]] = w[name] * rng.uniform(0.5, 1.5, (B, 1))
    for i in range(5):
        P[..., idx[f"spline_x{i}_c"]] = 1.0
        P[..., idx[f"spline_x{i}_d"]] = 5.0 * i
        P[..., idx[f"spline{i}_start"]] = 5.0 * i
    P[..., idx["ego_disc_radius"]] = 0.325
    Z = np.zeros((B, T, ocp.nvar))
    Z[..., ocp.nu + 0] = np.linspace(0.0, 3.0, T) + rng.normal(0, 0.1,
                                                               (B, T))
    Z[..., ocp.nu + 1] = rng.normal(0, 0.3, (B, T))
    Z[..., ocp.nu + 2] = rng.normal(0, 0.2, (B, T))
    Z[..., ocp.nu + 3] = rng.uniform(0.5, 1.5, (B, T))
    Z[..., ocp.nu + 4] = Z[..., ocp.nu + 0]
    Z[..., :ocp.nu] = rng.normal(0, 0.3, (B, T, ocp.nu))
    for name, col in idx.items():
        if not name.startswith("gaussian_obst_"):
            continue
        kind = name.rsplit("_", 1)[1]
        if kind == "x":
            P[..., col] = Z[..., ocp.nu] + rng.uniform(1.0, 3.0, (B, T))
        elif kind == "y":
            P[..., col] = rng.uniform(-1.5, 1.5, (B, T))
        elif kind in ("major", "minor"):
            P[..., col] = rng.uniform(0.05, 0.4, (B, T))
        elif kind == "risk":
            P[..., col] = rng.uniform(1e-3, 0.45, (B, 1))
        elif kind == "r":
            P[..., col] = 0.3
    for d in range(ocp.settings["n_discs"]):
        P[..., idx[f"ego_disc_{d}_offset"]] = 0.2 * d
    P[:, -1] = P[:, -2]
    x0 = Z[:, 0, ocp.nu:] + rng.normal(0, 0.01, (B, ocp.nx))
    return tuple(torch.as_tensor(a) for a in (P, x0, Z))


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------
def test_erfinv_newton_matches_jax_and_scipy():
    x = 1.0 - 2.0 * np.linspace(1e-3, 0.49, 200)
    got = t_erfinv(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_erfinv(jnp.asarray(x))),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, erfinv(x), rtol=1e-12, atol=0)


@pytest.mark.parametrize("modes,discs", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_gaussian_rows_match_jax(modes, discs):
    from torch.func import vmap

    jo = ccmpc_ocp("jax", modes=modes, discs=discs)
    to = ccmpc_ocp("torch", modes=modes, discs=discs)
    assert to.registry.save_map() == jo.registry.save_map()
    assert (to.nh, to.npar) == (jo.nh, jo.npar)
    assert to.nh == 2 * modes * discs
    assert list(to.ineq_row_spec()) == list(jo.ineq_row_spec())
    for name in ("lh", "uh"):
        np.testing.assert_array_equal(np.asarray(getattr(to, name)),
                                      np.asarray(getattr(jo, name)))
    P, _, Z = random_problems(to, 3, seed=modes + 2 * discs)
    Pf = P.reshape(-1, to.npar).numpy()
    Zf = Z.reshape(-1, to.nvar).numpy()
    want = np.asarray(jax.vmap(jo.ineq)(jnp.asarray(Zf), jnp.asarray(Pf)))
    got = vmap(to.ineq)(torch.as_tensor(Zf), torch.as_tensor(Pf)).numpy()
    assert np.isfinite(got).all() and (np.abs(got) > 0.01).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def _gmm_scene(types, dp, N, dt):
    """Two obstacles of each package's types: a two-mode GMM prediction
    (probabilities 0.7 / 0.3) and a static one-mode obstacle, so that mode 1
    of the second is absent."""
    data = types.RealTimeData()
    data.robot_area = dp.define_robot_area(0.65, 0.65, 1)
    gmm = types.DynamicObstacle(index=0, position=np.array([3.0, 0.2]),
                                radius=0.3)
    gmm.prediction = dp.get_gmm_prediction(
        [3.0, 0.2], [[-0.4, 0.1], [-0.2, -0.3]], [0.7, 0.3], dt, N,
        noise=0.1)
    static = types.DynamicObstacle(index=1, position=np.array([5.0, -0.5]),
                                   radius=0.4)
    static.type = types.ObstacleType.STATIC
    static.prediction = dp.get_constant_velocity_prediction(
        [5.0, -0.5], [0.0, 0.0], dt, N, probabilistic=True)
    data.dynamic_obstacles = [gmm, static]
    return data


def test_set_parameters_match_jax_on_a_gmm_scene():
    from oscar_mpc_planner_mr_modification_tpu_torch import types as ttypes
    from oscar_mpc_planner_mr_modification_tpu_torch.planner import (
        data_preparation as tdp)

    N, dt = 10, 0.2
    bufs = []
    for pkg, types, dp in (("jax", jtypes, jdp), ("torch", ttypes, tdp)):
        settings = (j_settings if pkg == "jax" else t_settings)(
            N=N, max_obstacles=2)
        settings["probabilistic"]["max_modes"] = 2
        mod = (jmodules if pkg == "jax" else tmodules).GaussianConstraintModule(
            settings)
        ocp = ccmpc_ocp(pkg, N=N, modes=2)
        data = _gmm_scene(types, dp, N, dt)
        assert mod.is_data_ready(data)

        class _State:
            def get(self, name):
                return {"x": 0.4, "y": -0.1}[name]

        mod.update(_State(), data, None)
        buf = ocp.registry.new_buffer(N)
        mod.set_parameters(buf, data, None)
        bufs.append(buf.data)
    np.testing.assert_array_equal(bufs[1], bufs[0])
    idx = ccmpc_ocp("torch", N=N, modes=2).registry.save_map()
    assert bufs[1][3, idx["gaussian_obst_1_m1_risk"]] == 0.49  # absent mode
    assert bufs[1][3, idx["gaussian_obst_1_major"]] == 1e-3  # static floor
    assert 0.0 < bufs[1][3, idx["gaussian_obst_0_m1_risk"]] < 0.49


# ---------------------------------------------------------------------------
# Kernel B2's header on the CC-MPC OCP (host build)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reg", ["gershgorin", "levenberg"])
def test_header_linearization_matches_torch_func(host, reg):
    ocp = ccmpc_ocp("torch", N=8, n_obstacles=3, modes=2)
    cfg = SQPConfig(regularization=reg, reg_eps=1e-4, levenberg=2e-3)
    tables = sqp_fused.ocp_tables(ocp, cfg)
    assert (tables.model, tables.nx, tables.nu, tables.mh) == (0, 5, 2, 6)
    assert tables.ints[sqp_fused.TB_SLACK] == -1
    mach = _make_machinery(ocp, cfg, F64, "cpu")
    P, x0, Z = random_problems(ocp, 4, seed=11)
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
    # the Gaussian rows' Jacobians are dense over x and y (disc offset 0)
    assert (got[0].D[:, :-1, :6, 2:4].abs() > 0).all()


@pytest.mark.parametrize("track_best", [False, True])
def test_header_solve_matches_fused_fleet_reference(host, track_best):
    ocp = ccmpc_ocp("torch", N=8, n_obstacles=3)
    cfg = SQPConfig(n_sqp=4, n_qp_iter=10, mu_min=1e-6, w_max=1e6,
                    reg_eps=1e-4, regularization="gershgorin",
                    track_best=track_best, qp_iter_schedule=((2, 6), (2, 10)))
    solve = make_fleet_sqp_solver(ocp, cfg, dtype=F64, device="cpu",
                                  backend="fused")
    P, x0, Z = random_problems(ocp, 4, seed=12)
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


# ---------------------------------------------------------------------------
# The CC-MPC evaluator
# ---------------------------------------------------------------------------
ROLL_N, ROLL_B, ROLL_TICKS, ROLL_OBS = 10, 8, 4, 3


@pytest.fixture(scope="module")
def gaussian_pair():
    kw = dict(n_obstacles=ROLL_OBS, N=ROLL_N, n_ticks=ROLL_TICKS,
              backend="xla", constraints="gaussian", risk=0.05,
              sigma_step=0.05)
    j, jocp = jro.make_contouring_rollout(
        dtype=jnp.float64, config=JSQPConfig(**ROLLOUT_CFG), **kw)
    t, tocp = tro.make_contouring_rollout(
        dtype=torch.float64, device="cpu", config=SQPConfig(**ROLLOUT_CFG),
        **kw)
    return (j, jocp), (t, tocp)


def gaussian_scenes(seed):
    """Contouring scenes with the obstacles moved near the start, so that
    the 4 ticks meet them."""
    x0, obs0, vel = tro.contouring_scenes(ROLL_B, ROLL_OBS, seed=seed)
    obs0 = obs0.astype(np.float64)
    obs0[:, :, 0] = obs0[:, :, 0] * 0.25 + 0.8
    return x0.astype(np.float64), obs0, vel.astype(np.float64)


def test_gaussian_first_tick_params_equal_jax(gaussian_pair):
    (j, jocp), (t, tocp) = gaussian_pair
    assert tocp.registry.save_map() == jocp.registry.save_map()
    args = gaussian_scenes(seed=4)
    got = t.first_tick_params(*args).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j.first_tick_params(*map(jnp.asarray, args))))
    idx = tocp.registry.save_map()
    np.testing.assert_array_equal(  # sigma_k = 0.05 sqrt(k + 1)
        got[0, :, idx["gaussian_obst_2_major"]],
        0.05 * np.sqrt(np.arange(1, ROLL_N + 1)))


def test_gaussian_rollout_matches_jax(gaussian_pair):
    (j, _), (t, _) = gaussian_pair
    args = gaussian_scenes(seed=5)
    want = j(*map(jnp.asarray, args))
    got = t(*args)
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
    # the robots moved and met the obstacles
    assert (got.progress.numpy() > 0.2).all()
    assert got.min_obstacle_dist.min().item() < 2.0
    assert got.solve_success_rate.min().item() > 0.5


def test_gaussian_evaluator_backend_and_rows():
    """``"auto"`` resolves from the device; the fused backend builds for the
    Gaussian OCP (its plain version on the CPU) with one Gaussian row per
    obstacle, and the cuda build of B2 is chosen without falling back."""
    t, ocp = tro.make_contouring_rollout(N=6, n_ticks=1, device="cpu",
                                         constraints="gaussian",
                                         dtype=F64)
    assert t.backend == "xla" and ocp.nh == 3
    f, ocp = tro.make_contouring_rollout(N=6, n_ticks=1, device="cpu",
                                         constraints="gaussian",
                                         backend="fused", dtype=F64)
    assert f.backend == "fused"
    tables = f.fleet_solve.tables
    kinds = tables.ints[tables.ints[sqp_fused.TB_OFF_H]:][
        :sqp_fused.H_W * ocp.nh:sqp_fused.H_W]
    assert list(kinds) == [sqp_fused.HK_GAUSSIAN] * 3
    assert tables.m == 3 + 14
