"""The single-instance kernel S1 (``csrc/sqp_single.cuh``, behind
``ops/sqp.py::make_sqp_solver`` and ``backend="xla"`` on a CUDA device),
its per-problem code compiled for the host with g++ and run on emulated
warps of 32 lanes (``ops/sqp_single.py``: ``solve.host``, ``host_mirror``,
``host_solve_qp``), on the CPU at f64 with inputs made from numpy seeds.

- (i) The whole solve against JAX's ``make_sqp_solver`` (x64, CPU) on
  configuration_basic at N=6 (the contouring_setup of tests/test_sqp.py)
  under ``"mirror"`` and ``"gershgorin"``: z within 1e-8 (1 + max|ref|),
  equal success and exit code; cost, eq_res and qp_comp equal to round-off
  (cost rtol 1e-10, eq_res atol 1e-12, qp_comp rtol 1e-6: sums in another
  order than XLA's).
- (ii) The same solve against the plain version
  (``ops/sqp.py::_make_reference_solver``, which equals JAX,
  tests/test_torch_sqp_single.py) under ``"levenberg"``, ``"none"`` and
  ``track_best=False``, a schedule, and on the JAX fleet-process demo's
  goal OCP (``tools/common.py::goal_demo_problem``: MPCBase, goal,
  ellipsoids on SecondOrderUnicycleModel); z within 1e-8
  (1 + max|ref|), the same success.
- (iii) ``mirror_stage`` against JAX's ``_mirror_regularize`` on seeded
  symmetric blocks (indefinite, with repeated eigenvalues, with a +-
  pair): within 1e-12 of the block's largest entry; a block with a NaN
  entry comes out all NaN.
- (iv) ``solve_qp_problem`` against JAX's ``ops/qp.py::solve_qp`` on the
  seven random QPs of tests/test_torch_qp.py on which JAX's own solve is
  stable to round-off (nu = 1..3 closed form, nu = 4 Cholesky, with and
  without active rows): z, s and lam within rtol 1e-9 (atol 1e-12), comp
  and eq_res within 1e-15; on that file's two QPs where JAX's solve is not
  stable, the quality measures it holds the plain solve to (feasibility,
  the equalities, complementarity, the objective); with every row masked;
  and a converged QP that runs into the freeze (60 iterations return
  exactly what 40 return).
- (v) The raises when the solver is built for a CUDA device, before the
  device is touched: an OCP the header does not cover
  (``NotImplementedError``), an (nx, nu) S1 is not compiled for
  (``ValueError``); ``INSTANTIATED`` is the models' dims.
- (vi) The block's width follows the batch (``sqp_single.block_warps``,
  the rule the card's launch plan and the host build share): 8 warps up to
  one wave of 8-warp blocks, then 4 and 2; and a batch the host runs at 4
  and at 2 warps per problem gives each problem the same bits as one
  problem alone at 8 (the sums keep one order whatever the width), so (i)
  holds at every width.

The host build runs each problem on the warps an H100 would run its batch
with (132 SMs, registers bounding the blocks): 8 for one problem.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops import qp as jqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import models  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.factory import (  # noqa: E402
    configuration_basic)
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    ContouringModule, EllipsoidConstraintModule, ModuleManager,
    MPCBaseModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    sqp_fused, sqp_single)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (  # noqa: E402
    goal_demo_problem)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

from test_sqp import contouring_setup  # noqa: E402
from test_torch_qp import objective, random_qp  # noqa: E402

F64 = torch.float64
N = 6
CFG = tsqp.SQPConfig(n_sqp=6, n_qp_iter=12, mu_min=1e-9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def basic():
    """configuration_basic at N=6 in both packages, with tests/test_sqp.py's
    inputs (numpy)."""
    jocp, P, x0, z_init = contouring_setup(N=N, n_obstacles=2)
    settings = default_settings(N=N, max_obstacles=2)
    ocp = build_ocp(*configuration_basic(settings), settings)
    assert ocp.registry.save_map() == jocp.registry.save_map()
    return jocp, ocp, P, x0, z_init


def host_solve(ocp, cfg, P, x0, z_init):
    """S1's per-problem code on the host: one problem, batchless fields."""
    solve = sqp_single.make_single_solver(ocp, cfg, dtype=F64, device="cpu")
    res = solve.host(P[None], x0[None], z_init[None])
    return tsqp.SQPResult(*(x[0] for x in res))


def assert_solve_close(got, want):
    z, ref = np.asarray(got.z), np.asarray(want.z)
    assert np.isfinite(z).all()
    np.testing.assert_allclose(z, ref, rtol=0,
                               atol=1e-8 * (1.0 + np.abs(ref).max()))
    assert bool(got.success) == bool(want.success)
    assert int(got.exit_code) == int(want.exit_code)


@pytest.mark.parametrize("reg", ["mirror", "gershgorin"])
def test_whole_solve_matches_jax(basic, reg):
    jocp, ocp, P, x0, z_init = basic
    cfg = CFG._replace(regularization=reg)
    want = jsqp.make_sqp_solver(jocp, cfg, dtype=jnp.float64)(
        jnp.asarray(P), jnp.asarray(x0), jnp.asarray(z_init))
    got = host_solve(ocp, cfg, P, x0, z_init)
    assert_solve_close(got, want)
    assert bool(got.success)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-10)
    np.testing.assert_allclose(float(got.eq_res), float(want.eq_res),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(got.qp_comp), float(want.qp_comp),
                               rtol=1e-6)
    assert float(got.qp_comp) > 0.0


@pytest.mark.parametrize("case", ["levenberg", "none", "last_iterate",
                                  "goal_mirror", "schedule"])
def test_whole_solve_matches_the_plain_version(basic, case):
    _, ocp, P, x0, z_init = basic
    cfg = CFG
    if case in ("levenberg", "none"):
        cfg = cfg._replace(regularization=case)
    elif case == "last_iterate":
        cfg = cfg._replace(track_best=False)
    elif case == "schedule":
        cfg = cfg._replace(qp_iter_schedule=((2, 4), (3, 10)))
    else:
        ocp, P, x0, z_init = goal_demo_problem(N)
    want = tsqp.make_sqp_solver(ocp, cfg, dtype=F64, device="cpu")(
        P, x0, z_init)
    got = host_solve(ocp, cfg, P, x0, z_init)
    assert_solve_close(got, want)
    assert bool(got.success)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-10)
    np.testing.assert_allclose(float(got.qp_comp), float(want.qp_comp),
                               rtol=1e-6)


def test_batched_host_solve_solves_each_problem_alone(basic):
    """Two problems in one call: each as the one-problem call gives it."""
    _, ocp, P, x0, z_init = basic
    solve = sqp_single.make_single_solver(ocp, CFG, dtype=F64, device="cpu")
    P2 = np.stack([P, P * (1.0 + 1e-3)])
    both = solve.host(P2, np.stack([x0, x0]), np.stack([z_init, z_init]))
    for b in range(2):
        one = solve.host(P2[b:b + 1], x0[None], z_init[None])
        assert torch.equal(both.z[b], one.z[0])
        assert torch.equal(both.cost[b], one.cost[0])
    assert not torch.equal(both.z[0], both.z[1])
    # built for the CPU, the solver launches nothing: its plain version is
    # .reference (make_sqp_solver's choice on the CPU)
    args = (torch.as_tensor(P2), torch.as_tensor(np.stack([x0, x0])),
            torch.as_tensor(np.stack([z_init, z_init])))
    with pytest.raises(ValueError, match="runs on cuda"):
        solve(*args)
    plain = solve.reference(*args)
    np.testing.assert_allclose(plain.z.numpy(), both.z.numpy(), rtol=0,
                               atol=1e-8 * (1.0 + plain.z.abs().max().item()))


def mirror_blocks():
    """Seeded symmetric blocks: indefinite, repeated eigenvalues (with a
    +- pair and a zero), and at the sizes S1 mirrors (nz = 7, 9; the x
    blocks 4, 5, 6)."""
    rng = np.random.default_rng(7)
    out = []
    for n in (4, 5, 6, 7, 9):
        M = rng.normal(size=(n, n))
        out.append(("indefinite", 0.5 * (M + M.T)))
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        lam = np.resize([3.0, 3.0, -3.0, 1e-9, 0.0, 3.0, -0.5], n)
        out.append(("repeated", (Q * lam) @ Q.T))
        out.append(("diagonal", np.diag(rng.normal(size=n))))
    return out


def test_mirror_stage_matches_jax():
    eps = 1e-6
    for name, H in mirror_blocks():
        want = np.asarray(jsqp._mirror_regularize(jnp.asarray(H), eps))
        got = sqp_single.host_mirror(H, eps)
        err = np.abs(got - want).max()
        assert err <= 1e-12 * np.abs(want).max(), (name, H.shape, err)
        np.testing.assert_array_equal(got, got.T)
    H = mirror_blocks()[0][1].copy()
    H[1, 2] = H[2, 1] = np.nan
    assert np.isnan(np.asarray(jsqp._mirror_regularize(jnp.asarray(H),
                                                       eps))).all()
    assert np.isnan(sqp_single.host_mirror(H, eps)).all()


def jax_qp(raw, nu, **kw):
    return jqp.solve_qp(jqp.QPData(*map(jnp.asarray, raw)), nu=nu, **kw)


def assert_qp_close(got, want):
    z, s, lam, comp, eq_res = got
    for name, x in (("z", z), ("s", s), ("lam", lam)):
        np.testing.assert_allclose(x, np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(comp, float(want.comp), rtol=0, atol=1e-15)
    np.testing.assert_allclose(eq_res, float(want.eq_res), rtol=0, atol=1e-15)


@pytest.mark.parametrize("seed,nu,tighten", [
    (0, 1, 0.0), (29, 1, 0.5), (6, 2, 0.0), (29, 2, 0.2), (13, 2, 0.3),
    (0, 3, 0.2), (12, 4, 0.5)],
    ids=["nu1", "nu1-active", "nu2", "nu2-active", "nu2-active-2",
         "nu3-active", "nu4-cholesky-active"])
def test_solve_qp_problem_matches_jax(seed, nu, tighten):
    raw = random_qp(seed, nu=nu, tighten=tighten)
    kw = dict(n_iters=30, mu_min=1e-9)
    want = jax_qp(raw, nu, **kw)
    got = sqp_single.host_solve_qp(*raw, nu=nu, **kw)
    assert_qp_close(got, want)


@pytest.mark.parametrize("seed,nu,tighten", [(2, 2, 0.5), (9, 3, 0.3)],
                         ids=["nu2-unstable", "nu3-unstable"])
def test_solve_qp_problem_quality_where_jax_is_unstable(seed, nu, tighten):
    """tests/test_torch_qp.py's QPs on which JAX's own solve moves by more
    than 1e-5 when g moves by 1e-15: held to the quality of JAX's solution
    (feasible, the equalities to 1e-12, complementarity at most twice
    JAX's, the objective within rtol 1e-7), not to its z."""
    raw = random_qp(seed, nu=nu, tighten=tighten)
    H, g, A, B, c, D, e, mask, r0 = raw
    kw = dict(n_iters=30, mu_min=1e-9)
    want = jax_qp(raw, nu, **kw)
    z, _, _, comp, eq_res = sqp_single.host_solve_qp(*raw, nu=nu, **kw)
    assert np.isfinite(z).all()
    vals = np.einsum("tmz,tz->tm", D, z) + e
    assert vals[mask > 0].min() > -1e-6  # feasible
    dyn = (np.einsum("tij,tj->ti", A, z[:-1, nu:])
           + np.einsum("tij,tj->ti", B, z[:-1, :nu]) + c - z[1:, nu:])
    assert max(np.abs(dyn).max(), np.abs(r0 - z[0, nu:]).max()) < 1e-12
    assert eq_res < 1e-12
    assert comp <= 2.0 * float(want.comp)
    np.testing.assert_allclose(objective(raw, z),
                               objective(raw, np.asarray(want.z)), rtol=1e-7)


def test_solve_qp_problem_every_row_masked():
    raw = list(random_qp(6, nu=2))
    raw[7] = np.zeros_like(raw[7])
    want = jax_qp(raw, 2, n_iters=10, mu_min=1e-9)
    got = sqp_single.host_solve_qp(*raw, nu=2, n_iters=10, mu_min=1e-9)
    assert_qp_close(got, want)
    assert got[3] == 0.0 and np.all(got[1] == 1.0) and np.all(got[2] == 0.0)


def test_solve_qp_problem_freezes_when_converged():
    raw = random_qp(29, tighten=0.2)
    got40 = sqp_single.host_solve_qp(*raw, nu=2, n_iters=40, mu_min=1e-9)
    got60 = sqp_single.host_solve_qp(*raw, nu=2, n_iters=60, mu_min=1e-9)
    for a, b in zip(got40, got60):
        np.testing.assert_array_equal(a, b)
    assert_qp_close(got40, jax_qp(raw, 2, n_iters=40, mu_min=1e-9))
    assert got40[3] < 1e-9


def test_what_s1_does_not_cover_raises(monkeypatch):
    settings = default_settings(N=6, max_obstacles=1)
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(ContouringModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    uncovered = build_ocp(models.SecondOrderUnicycleModel(), mm, settings)
    with pytest.raises(NotImplementedError, match="spline state"):
        tsqp.make_sqp_solver(uncovered, CFG, dtype=F64, device="cuda")
    with pytest.raises(NotImplementedError, match="spline state"):
        tsqp.make_fleet_sqp_solver(uncovered, CFG, dtype=F64, device="cuda",
                                   backend="xla")
    # the CPU runs the plain version, which covers it
    assert callable(tsqp.make_sqp_solver(uncovered, CFG, dtype=F64,
                                         device="cpu"))
    ocp, *_ = goal_demo_problem(N)
    with pytest.raises(ValueError, match="eigen"):
        sqp_fused.ocp_tables(ocp, CFG._replace(regularization="eigen"),
                             mirror=True)
    with pytest.raises(ValueError, match="mirror"):
        sqp_fused.ocp_tables(ocp, CFG)  # B2 still refuses "mirror"
    assert sqp_fused.ocp_tables(ocp, CFG, mirror=True).reg == (
        sqp_fused.REG_MIRROR)
    dims = {(getattr(models, name)().nx, getattr(models, name)().nu)
            for name in sqp_fused.MODELS}
    assert dims == set(sqp_single.INSTANTIATED)
    monkeypatch.setattr(sqp_single, "INSTANTIATED", ((5, 2),))
    with pytest.raises(ValueError, match=r"not \(4, 2\)"):
        tsqp.make_sqp_solver(ocp, CFG, dtype=F64, device="cuda")


@pytest.mark.parametrize("problems,per_sm,warps", [
    (1, (1, 2, 4), 8), (132, (1, 2, 4), 8), (133, (1, 2, 4), 4),
    (264, (1, 2, 4), 4), (265, (1, 2, 4), 2), (4608, (1, 2, 4), 2),
    (4608, (1, 2, 2), 4), (4608, (1, 1, 1), 8), (4608, (0, 0, 1), 2),
    (4608, (0, 0, 0), 0)])
def test_block_width_follows_the_batch(problems, per_sm, warps):
    assert sqp_single.block_warps(problems, 132, per_sm) == warps


@pytest.mark.parametrize("problems", [133, 265], ids=["4-warps", "2-warps"])
def test_batch_width_gives_each_problem_its_bits(basic, problems):
    _, ocp, P, x0, z_init = basic
    cfg = CFG._replace(regularization="mirror")
    solve = sqp_single.make_single_solver(ocp, cfg, dtype=F64, device="cpu")
    one = solve.host(P[None], x0[None], z_init[None])
    many = solve.host(*(np.repeat(a[None], problems, axis=0)
                        for a in (P, x0, z_init)))
    for a, b in zip(one, many):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert torch.equal(b, a.expand_as(b))
