"""The bicycle models and ``configuration_bicycle`` in the port against the
JAX package, on the CPU at f64, with kernel B1 at (nx, nu) = (6, 3) and B2's
two bicycle models.

- ``BicycleModel2ndOrder``'s step and its Jacobian equal JAX's to 1e-12
  (the curvature-aware bicycle is held in tests/test_torch_ca_contouring.py).
- ``configuration_bicycle``, both flavours: the registry, npar, bounds, row
  spec, stage cost, rows and dynamics equal JAX's (1e-12).
- The ``bicycle_contouring`` golden through the port's ``make_sqp_solver``
  at the tolerances JAX holds its own drift to (tests/test_golden.py: z
  atol 1e-6, cost rtol 1e-8).
- B1's plain version (``ip_solve_reference``) at (6, 3) solves converged,
  stable QPs as JAX's ``solve_qp`` does (atol 1e-8), and its host build
  equals it (1e-8 (1 + max|ref|)).
- B2's header compiled for the host linearizes both bicycle OCPs as
  ``torch.func`` does (rtol 1e-9, atol 1e-10) and the plain one as the JAX
  lane linearizer does (rtol 1e-9, atol 1e-9; the curvature-aware one in
  tests/test_torch_road_width.py); its solve equals
  ``fused_fleet_reference`` (1e-6 per problem, the card's gate).
- ``fused_fleet_reference`` equals the JAX ``"xla"`` fleet solve where the
  QPs converge: the same success mask, z atol 2e-4, cost without its slack
  term rtol 1e-5 (the kernels' IP freezes at residual 1e-5, short of the
  slack input's bound; ROADMAP Queue C's terms).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as jfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import models as jmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import qp as jqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.linearize import (  # noqa: E402
    make_lane_linearizer, make_lane_merit)
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    build_ocp as jbuild_ocp)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as jdefault_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import models as tmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.tools import (  # noqa: E402
    bench_matrix)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

from test_qp import random_qp  # noqa: E402

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FUSED_F64_GATE = 1e-6


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def bicycle_pair(N, curvature_aware=False, **overrides):
    """The JAX and the port's configuration_bicycle OCPs at the same
    settings; their parameter maps are equal."""
    jo = jbuild_ocp(*jfactory.configuration_bicycle(
        js := jdefault_settings(N=N, **overrides), curvature_aware), js)
    to = build_ocp(*factory.configuration_bicycle(
        ts := default_settings(N=N, **overrides), curvature_aware), ts)
    assert to.registry.save_map() == jo.registry.save_map()
    return jo, to


@pytest.fixture(scope="module")
def fleets():
    """A 4-problem f64 bicycle fleet of each flavour (tools/bench_matrix.py's
    builder, N=8) with both OCPs: name -> (jax ocp, port ocp, P with stage
    N repeating N-1, x0, Z moved off the warm start)."""
    out = {}
    for ca in (False, True):
        ocp, P, x0, z0 = bench_matrix.build_bicycle(
            8, 4, np.random.default_rng(3), curvature_aware=ca)
        jo, to = bicycle_pair(8, ca)
        assert to.registry.save_map() == ocp.registry.save_map()
        rng = np.random.default_rng(4)
        P = np.concatenate([P, P[:, -1:]], axis=1).astype(np.float64)
        Z = z0.astype(np.float64) + 0.05 * rng.normal(size=z0.shape)
        out[ca] = (jo, to, P, x0.astype(np.float64), Z)
    return out


# ---------------------------------------------------------------------------
# Model and configuration
# ---------------------------------------------------------------------------
def test_bicycle_dynamics_and_jacobian_match_jax():
    jm, tm = jmodels.BicycleModel2ndOrder(), tmodels.BicycleModel2ndOrder()
    assert (tm.nx, tm.nu, tm.states, tm.inputs, tm.width) == (
        jm.nx, jm.nu, jm.states, jm.inputs, jm.width)
    assert (tm.lower_bound, tm.upper_bound) == (jm.lower_bound,
                                                jm.upper_bound)

    def jf(v):
        return jm.discrete_dynamics(v[:6], v[6:], 0.2)

    def tf(v):
        return tm.discrete_dynamics(v[:6], v[6:], 0.2)

    jstep, jjac = jax.jit(jf), jax.jit(jax.jacfwd(jf))
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = rng.normal(size=6) * np.array([3.0, 3.0, 1.0, 1.0, 0.3, 3.0])
        x[3] = abs(x[3]) + 0.5
        xu = np.concatenate([x, rng.normal(size=3)])
        np.testing.assert_allclose(tf(torch.as_tensor(xu)).numpy(),
                                   np.asarray(jstep(jnp.asarray(xu))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            torch.func.jacfwd(tf)(torch.as_tensor(xu)).numpy(),
            np.asarray(jjac(jnp.asarray(xu))), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("curvature_aware", [False, True])
def test_configuration_bicycle_matches_jax(curvature_aware):
    from torch.func import vmap

    jo, to = bicycle_pair(30, curvature_aware)
    assert (to.N, to.nx, to.nu, to.nvar, to.npar, to.nh) == (
        jo.N, jo.nx, jo.nu, jo.nvar, jo.npar, jo.nh) == (30, 6, 3, 9, 84, 4)
    assert type(to.model).__name__ == type(jo.model).__name__
    assert list(to.ineq_row_spec()) == list(jo.ineq_row_spec())
    assert len(to.ineq_row_spec()) == 22
    for name in ("lh", "uh", "lbz", "ubz"):
        np.testing.assert_array_equal(np.asarray(getattr(to, name)),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    ocp, P, x0, z0 = bench_matrix.build_bicycle(
        30, 2, np.random.default_rng(1), curvature_aware=curvature_aware)
    rng = np.random.default_rng(2)
    Pf = P.reshape(-1, to.npar).astype(np.float64)
    Zf = (z0[:, :-1].reshape(-1, to.nvar)
          + 0.1 * rng.normal(size=(Pf.shape[0], to.nvar)))
    jz, jp = jnp.asarray(Zf), jnp.asarray(Pf)
    tz, tp = torch.as_tensor(Zf), torch.as_tensor(Pf)
    for fn in ("cost_stage", "ineq"):
        np.testing.assert_allclose(
            vmap(getattr(to, fn))(tz, tp).numpy(),
            np.asarray(jax.vmap(getattr(jo, fn))(jz, jp)), rtol=1e-12,
            atol=1e-12, err_msg=fn)
    got = vmap(to.dynamics)(tz[:, 3:], tz[:, :3], tp).numpy()
    want = np.asarray(jax.vmap(jo.dynamics)(jz[:, 3:], jz[:, :3], jp))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_bicycle_golden_through_make_sqp_solver():
    gold = np.load(os.path.join(GOLDEN, "bicycle_contouring.npz"))
    _, to = bicycle_pair(15, max_obstacles=2)
    assert gold["P"].shape == (15, to.npar)
    solve = tsqp.make_sqp_solver(to, tsqp.SQPConfig(n_sqp=15, n_qp_iter=15),
                                 dtype=F64, device="cpu")
    res = solve(gold["P"], gold["x0"], gold["z_init"])
    assert bool(res.success)
    np.testing.assert_allclose(res.z.numpy(), gold["Z"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res.cost), float(gold["cost"]),
                               rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# B1 at (6, 3)
# ---------------------------------------------------------------------------
def test_b1_plain_at_6_3_matches_jax_solve_qp():
    """Random QPs with nx=6, nu=3 (T=5, 4 generic rows), converged (40
    iterations, mu_min 1e-10, no freeze before 1e-10): the kernel's plain
    version and JAX's ``solve_qp`` reach the same solution. The seeds are
    ones with 2-3 rows active at the solution whose solution a 1e-13 move
    of g moves by less than 1e-8 (ROADMAP's parity terms: on QPs near
    the boundary JAX's own solve moves by far more)."""
    seeds = (4, 11, 17)
    raws = [random_qp(seed, T=5, nx=6, nu=3, m=4)[1] for seed in seeds]
    batch = [np.stack([raw[i] for raw in raws]) for i in range(9)]
    z = qp_cuda.ip_solve_reference(
        *[torch.as_tensor(x) for x in batch[:7]], batch[7][0],
        torch.as_tensor(batch[8]), nu=3, n_iters=40, mu_min=1e-10,
        w_max=1e14, tol_freeze=1e-10).numpy()
    for b, raw in enumerate(raws):
        sols = [np.asarray(jqp.solve_qp(jqp.QPData(*[
            jnp.asarray(x + (1e-13 if i == 1 and moved else 0.0))
            for i, x in enumerate(raw)]), nu=3, n_iters=40,
            mu_min=1e-10).z) for moved in (False, True)]
        assert np.abs(sols[1] - sols[0]).max() < 1e-8, seeds[b]
        slack = np.einsum("tmz,tz->tm", raw[5], sols[0]) + raw[6]
        assert ((np.abs(slack) < 1e-6) & (raw[7] > 0)).sum() >= 2
        np.testing.assert_allclose(z[b], sols[0], rtol=0, atol=1e-8)
    qp_cuda.check_instantiated(6, 3)


def test_b1_host_build_at_6_3_matches_plain(host, fleets):
    _, to, P, x0, Z = fleets[False]
    cfg = tsqp.SQPConfig(regularization="gershgorin", reg_eps=1e-4)
    mach = tsqp._make_machinery(to, cfg, F64, "cpu")
    qp = mach.build_qp(*(torch.as_tensor(a) for a in (Z, P, x0)))
    assert qp.A.shape[-1] == 6 and qp.B.shape[-1] == 3
    kw = dict(nu=3, n_iters=15, mu_min=1e-6, w_max=1e6,
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
    assert (z - want).abs().max().item() <= 1e-8 * (
        1.0 + want.abs().max().item())


# ---------------------------------------------------------------------------
# B2's header on the bicycles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("curvature_aware", [False, True])
def test_header_linearization_matches_torch_func(host, fleets,
                                                 curvature_aware):
    _, to, P, x0, Z = fleets[curvature_aware]
    cfg = tsqp.SQPConfig(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, cfg)
    assert (tables.model, tables.nx, tables.nu, tables.m, tables.mh) == (
        sqp_fused.MODELS[type(to.model).__name__], 6, 3, 22, 4)
    assert tables.ints[sqp_fused.TB_SLACK] == to.registry.index("slack")
    mach = tsqp._make_machinery(to, cfg, F64, "cpu")
    got = sqp_fused.host_linearize(tables, P, x0, Z)
    lanes = sqp_fused.host_linearize(tables, P, x0, Z, lanes=True)
    want = sqp_fused.linearize_reference(
        mach, tables, *(torch.as_tensor(a) for a in (P, x0, Z)))
    for name, a, b in zip(sqp_fused.QPData._fields + ("merit", "cost",
                                                      "eq_res"),
                          (*got[0], *got[1:]), (*want[0], *want[1:])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for a, b in zip((*lanes[0], *lanes[1:]), (*got[0], *got[1:])):
        assert torch.equal(a, b)
    # the slack input enters the cost: its Hessian entry is 2 w_s (+ shift)
    assert bool((got[0].H[:, :-1, 2, 2] >= 2 * 1e4).all())


def test_header_linearization_matches_jax_lane_linearizer(host, fleets):
    """The plain bicycle (the curvature-aware one with the road-width and
    decomp rows: tests/test_torch_road_width.py)."""
    jo, to, P, x0, Z = fleets[False]
    cfg = dict(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, tsqp.SQPConfig(**cfg))
    qp, merit, cost, eq_res = sqp_fused.host_linearize(tables, P, x0, Z)
    jcfg = jsqp.SQPConfig(**cfg)
    lanes = (jnp.asarray(np.transpose(P, (2, 1, 0))),
             jnp.asarray(np.transpose(Z, (1, 2, 0))), jnp.asarray(x0.T))
    lq = make_lane_linearizer(jo, jcfg, jnp.float64)(*lanes)
    lm = make_lane_merit(jo, jcfg, jnp.float64)(*lanes)
    ours = {"H": qp.H, "g": qp.g, "A": qp.A, "B": qp.B, "c": qp.c,
            "D": qp.D[:, :, list(tables.generic)], "e": qp.e, "r0": qp.r0}
    for name, want in zip(lq._fields, lq):
        np.testing.assert_allclose(ours[name].numpy(),
                                   np.moveaxis(np.asarray(want), -1, 0),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), (merit, cost, eq_res),
                          lm[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_header_solve_matches_fused_fleet_reference(host, fleets):
    _, to, P, x0, Z = fleets[True]
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                         reg_eps=1e-4, regularization="gershgorin",
                         qp_iter_schedule=((2, 5), (2, 8)))
    solve = tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                       backend="fused")
    args = tuple(torch.as_tensor(a) for a in (P[:, :-1], x0, Z))
    launches = sqp_fused.launches
    got = solve.host(*args)
    want = solve(*args)
    assert sqp_fused.launches == launches
    assert bool((got.success == want.success).all())
    rel = ((got.z - want.z).abs().amax(dim=(1, 2))
           / (1.0 + want.z.abs().amax(dim=(1, 2))))
    assert rel.max().item() <= FUSED_F64_GATE


def test_fused_reference_matches_jax_xla():
    """The bicycle fleet (N=8, 4 problems from the warm start) at a
    converged schedule (10 x 20, mu_min 1e-10). The kernels' IP freezes at
    residual 1e-5, which leaves the slack input (bound 0, weight 1e4)
    ~3e-5 inside its bound where JAX's reaches ~6e-8: the costs are
    compared without their slack terms w_s sum_t slack_t^2."""
    ocp, P, x0, z0 = bench_matrix.build_bicycle(8, 4,
                                                np.random.default_rng(7))
    jo, to = bicycle_pair(8)
    P, x0, z0 = (a.astype(np.float64) for a in (P, x0, z0))
    kw = dict(n_sqp=10, n_qp_iter=20, mu_min=1e-10,
              regularization="gershgorin", track_best=False)
    ref = jsqp.make_fleet_sqp_solver(jo, jsqp.SQPConfig(**kw),
                                     dtype=jnp.float64, backend="xla")(
        *map(jnp.asarray, (P, x0, z0)))
    got = tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**kw), dtype=F64,
                                     device="cpu", backend="fused")(
        *(torch.as_tensor(a) for a in (P, x0, z0)))
    ok = np.asarray(ref.success)
    assert ok.all() and (got.success.numpy() == ok).all()
    w_s = P[:, 0, to.registry.index("slack")]
    z_j, z_t = np.asarray(ref.z), got.z.numpy()

    def without_slack(cost, z):
        return cost - w_s * np.sum(z[:, :-1, 2] ** 2, axis=1)

    np.testing.assert_allclose(without_slack(got.cost.numpy(), z_t),
                               without_slack(np.asarray(ref.cost), z_j),
                               rtol=1e-5)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=2e-4)
