"""BASELINE config 1 (the goal flavour) in the port, against the JAX package
and the committed goldens, on the CPU at f64.

- ``SecondOrderUnicycleModel.discrete_dynamics`` against JAX's, to 1e-12.
- The goal OCP (MPCBase weighing a and w, GoalModule, 3 ellipsoids) through
  ``build_ocp``: sizes, parameter layout, inequality rows and bounds equal
  to JAX's.
- The ``goal_tracking_3obs`` golden through the port's ``make_sqp_solver``
  at f64: Z within atol 1e-6, cost within rtol 1e-8 (the terms of the JAX
  package's ``tests/test_golden.py``). The setup is rebuilt here from the
  port's modules; its inputs equal the golden's.
- BASELINE's f32 gate (``examples/validate_tpu.py``: the golden's problem
  tiled to 4, n_sqp 25, n_qp_iter 15, mu_min 1e-6, w_max 1e6, Gershgorin)
  through the plain versions of kernel B1 (``backend="pallas"``) and kernel
  B2 (``backend="fused"``): max|U32 - U64| <= 1e-3 against
  ``tests/golden/validate_goal_U64.npy``. The kernels themselves are held to
  the same gate on the card by ``chip_smoke.py``.
- Kernel B2's header on the goal OCP, compiled for the host: its
  linearization against ``torch.func`` (rtol 1e-9, atol 1e-10), its lane
  form equal to its serial form, and its whole solve against
  ``fused_fleet_reference`` (1e-6 per problem, same success).
- Kernel B1's host build at (nx, nu) = (4, 2) against
  ``ip_solve_reference``: within 1e-8 (1 + max|ref|).
- What the kernels do not cover raises before any launch: an OCP the
  header does not cover (``NotImplementedError``), an (nx, nu) with no
  instantiation (``ValueError``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import models as jmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jro)
from oscar_mpc_planner_mr_modification_tpu_torch import models  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    ContouringModule, EllipsoidConstraintModule, GoalModule, ModuleManager,
    MPCBaseModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPConfig, _make_machinery, make_fleet_sqp_solver, make_sqp_solver)
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    rollout as tro)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import (  # noqa: E402
    build_ocp)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GATE_CFG = dict(n_sqp=25, n_qp_iter=15, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
                regularization="gershgorin")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def goal_tracking_setup(N=20, n_obstacles=3):
    """The JAX suite's ``goal_tracking_setup`` (tests/test_sqp.py) on the
    port's modules: ``(ocp, P (N, npar), x0, z_init)``."""
    ocp, _ = tro._goal_ellipsoid_ocp(n_obstacles, N)
    idx = ocp.registry.save_map()
    P = np.zeros((N, ocp.npar))
    P[:, idx["acceleration"]] = 0.34
    P[:, idx["angular_velocity"]] = 0.85
    P[:, idx["goal_weight"]] = 1.0
    P[:, idx["goal_x"]] = 5.0
    P[:, idx["goal_y"]] = 1.5
    P[:, idx["ego_disc_radius"]] = 0.325
    P[:, idx["ego_disc_0_offset"]] = 0.0
    obstacles = [(2.0, 0.4), (3.5, 1.2), (4.5, 0.2)][:n_obstacles]
    for i, (ox, oy) in enumerate(obstacles):
        P[:, idx[f"ellipsoid_obst_{i}_x"]] = ox
        P[:, idx[f"ellipsoid_obst_{i}_y"]] = oy
        P[:, idx[f"ellipsoid_obst_{i}_psi"]] = 0.0
        P[:, idx[f"ellipsoid_obst_{i}_major"]] = 0.0
        P[:, idx[f"ellipsoid_obst_{i}_minor"]] = 0.0
        P[:, idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[:, idx[f"ellipsoid_obst_{i}_r"]] = 0.3
    x0 = np.array([0.0, 0.0, 0.0, 0.5])
    z_init = np.zeros((N + 1, ocp.nvar))
    z_init[:, ocp.nu:] = x0
    return ocp, P, x0, z_init


@pytest.fixture(scope="module")
def golden():
    gold = np.load(os.path.join(GOLDEN, "goal_tracking_3obs.npz"))
    ocp, P, x0, z_init = goal_tracking_setup()
    np.testing.assert_array_equal(P, gold["P"])
    np.testing.assert_array_equal(x0, gold["x0"])
    np.testing.assert_array_equal(z_init, gold["z_init"])
    return ocp, gold


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def test_dynamics_match_jax():
    rng = np.random.default_rng(0)
    jm = jmodels.SecondOrderUnicycleModel()
    tm = models.SecondOrderUnicycleModel()
    assert (tm.nx, tm.nu, tm.states, tm.inputs) == (jm.nx, jm.nu, jm.states,
                                                    jm.inputs)
    assert tm.lower_bound == jm.lower_bound
    assert tm.upper_bound == jm.upper_bound
    for _ in range(5):
        x = rng.normal(size=4) * np.array([3.0, 3.0, 2.0, 1.0])
        u = rng.normal(size=2)
        want = np.asarray(jm.discrete_dynamics(jnp.asarray(x), jnp.asarray(u),
                                               0.2))
        got = tm.discrete_dynamics(torch.as_tensor(x), torch.as_tensor(u),
                                   0.2).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_goal_ocp_matches_jax():
    jocp, _ = jro._goal_ellipsoid_ocp(3, 12)
    tocp, _ = tro._goal_ellipsoid_ocp(3, 12)
    assert (tocp.nx, tocp.nu, tocp.npar, tocp.N, tocp.nh) == (
        jocp.nx, jocp.nu, jocp.npar, jocp.N, jocp.nh)
    assert tocp.registry.save_map() == jocp.registry.save_map()
    assert list(tocp.ineq_row_spec()) == list(jocp.ineq_row_spec())
    for name in ("lh", "uh", "lbz", "ubz"):
        np.testing.assert_array_equal(np.asarray(getattr(tocp, name)),
                                      np.asarray(getattr(jocp, name)),
                                      err_msg=name)


def test_goal_golden_through_make_sqp_solver(golden):
    ocp, gold = golden
    solve = make_sqp_solver(ocp, SQPConfig(n_sqp=10, n_qp_iter=20,
                                           mu_min=1e-10), dtype=F64,
                            device="cpu")
    res = solve(gold["P"], gold["x0"], gold["z_init"])
    assert bool(res.success)
    np.testing.assert_allclose(res.z.numpy(), gold["Z"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res.cost), float(gold["cost"]),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_f32_gate_through_the_plain_kernels(golden, backend):
    ocp, gold = golden
    U64 = np.load(os.path.join(GOLDEN, "validate_goal_U64.npy"))
    fleet = make_fleet_sqp_solver(ocp, SQPConfig(**GATE_CFG),
                                  dtype=torch.float32, device="cpu",
                                  backend=backend)
    tiled = (np.tile(gold["P"][None], (4, 1, 1)),
             np.tile(gold["x0"][None], (4, 1)),
             np.tile(gold["z_init"][None], (4, 1, 1)))
    out = fleet(*tiled)
    assert out.z.dtype == torch.float32
    assert bool(out.success.all())
    U32 = out.z.numpy()[:, :-1, :ocp.nu]
    assert np.abs(U32 - U64[None]).max() <= 1e-3


def _gate_problems(ocp, gold):
    """Four problems of the goal OCP: the golden's start, its solution, and
    both moved off (so every term and defect is nonzero); P with stage N
    repeating N-1."""
    rng = np.random.default_rng(5)
    Z = np.stack([gold["z_init"], gold["Z"], gold["Z"], gold["z_init"]])
    Z[2:] += 0.05 * rng.normal(size=Z[2:].shape)
    P = np.tile(gold["P"][None], (4, 1, 1))
    P = np.concatenate([P, P[:, -1:]], axis=1)
    x0 = np.tile(gold["x0"][None], (4, 1)) + np.array([[0.0], [0.0], [0.01],
                                                       [-0.01]])
    return tuple(torch.as_tensor(a) for a in (P, x0, Z))


@pytest.mark.parametrize("reg", ["gershgorin", "levenberg"])
def test_header_linearization_matches_torch_func(golden, host, reg):
    ocp, gold = golden
    cfg = SQPConfig(regularization=reg, reg_eps=1e-4, levenberg=2e-3)
    tables = sqp_fused.ocp_tables(ocp, cfg)
    assert (tables.model, tables.nx, tables.nu) == (1, 4, 2)
    assert tables.ints[sqp_fused.TB_VEL] == -1  # MPCBase weighs no v
    mach = _make_machinery(ocp, cfg, F64, "cpu")
    P, x0, Z = _gate_problems(ocp, gold)
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
    assert (got[2] > 0).all() and (got[3] > 0).all()


@pytest.mark.parametrize("track_best", [False, True])
def test_header_solve_matches_fused_fleet_reference(golden, host,
                                                    track_best):
    ocp, gold = golden
    cfg = SQPConfig(n_sqp=4, n_qp_iter=10, mu_min=1e-6, w_max=1e6,
                    reg_eps=1e-4, regularization="gershgorin",
                    track_best=track_best, qp_iter_schedule=((2, 6), (2, 10)))
    solve = make_fleet_sqp_solver(ocp, cfg, dtype=F64, device="cpu",
                                  backend="fused")
    P, x0, Z = _gate_problems(ocp, gold)
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


def test_qp_host_build_at_4_2_matches_plain(golden, host):
    ocp, gold = golden
    cfg = SQPConfig(**GATE_CFG)
    mach = _make_machinery(ocp, cfg, F64, "cpu")
    P, x0, Z = _gate_problems(ocp, gold)
    qp = mach.build_qp(Z, P, x0)
    assert qp.A.shape[-1] == 4 and qp.B.shape[-1] == 2
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


def test_what_the_kernels_do_not_cover_raises():
    settings = default_settings(N=6, max_obstacles=1)
    # contouring needs a spline state
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(ContouringModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    ocp = build_ocp(models.SecondOrderUnicycleModel(), mm, settings)
    cfg = SQPConfig(regularization="gershgorin")
    with pytest.raises(NotImplementedError, match="spline state"):
        sqp_fused.ocp_tables(ocp, cfg)
    # raised when the solver is built, before a device is touched
    with pytest.raises(NotImplementedError):
        make_fleet_sqp_solver(ocp, cfg, dtype=torch.float32, device="cuda",
                              backend="fused")
    # MPCBase weighing a alone
    mm = ModuleManager()
    mm.add_module(MPCBaseModule(settings)).weigh_variable("a", "acceleration")
    mm.add_module(GoalModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    ocp = build_ocp(models.SecondOrderUnicycleModel(), mm, settings)
    with pytest.raises(NotImplementedError, match="MPCBaseModule"):
        sqp_fused.ocp_tables(ocp, cfg)
    # B1 and B2 are compiled for (5, 2), (4, 2), (6, 2) and (6, 3)
    qp_cuda.check_instantiated(4, 2)
    with pytest.raises(ValueError, match=r"not \(7, 3\)"):
        qp_cuda.check_instantiated(7, 3)
