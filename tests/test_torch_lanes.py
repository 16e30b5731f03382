"""The port's lane path (``backend="lanes"``: the fused kernel's
linearization entry, then the QP kernel on its output buffer) against the
JAX package and against the port's per-iteration path, on the CPU at
float64, where the plain versions run.

- ``solve_qp_lanes`` (LaneQP layouts, the batch on the trailing axis) vs the
  JAX Pallas kernel's ``solve_qp_lanes`` in interpret mode: the same
  algorithm, atol 1e-8.
- ``make_lane_linearizer`` / ``make_lane_merit`` vs the JAX functions of the
  same names on the same inputs, field by field (atol 1e-9: JAX's atan2 is a
  Newton-polished rational, torch's is libm).
- ``backend="lanes"`` vs ``backend="pallas"``: the same SQP on the same QPs
  (the lane QP's stage-N placeholders sit on masked rows), so equal to
  1e-9 relative; and ``solve_qp_fields`` on the linearizer's fields equals
  ``solve_qp_lanes`` on the same QP as a LaneQP.
- Slow: ``backend="lanes"`` vs the JAX lane path in interpret mode.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as jbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import linearize as jlin  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.qp_pallas import (  # noqa: E402
    solve_qp_lanes as jax_lanes)
from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    linearize, qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402

from test_qp import random_qp  # noqa: E402
from test_torch_qp_kernel import _with_box_rows  # noqa: E402

F64 = torch.float64
BENCH_SCHEDULE = ((1, 3), (1, 5), (2, 8))
CFG = dict(mu_min=1e-6, w_max=1e6, reg_eps=1e-4, regularization="gershgorin")


def _lane_inputs(N, batch, seed=0, perturb=True):
    """Bench OCPs of both packages and one f64 fleet in lane layouts:
    P_cols (npar, T, B), Z_fields (T, nz, B), x_cols (nx, B); the consistency
    cost on, and the iterate moved off the warm start."""
    jo, js = jbench.tmpc_bench_ocp(N=N, n_paths=2)
    to, _ = tbench.tmpc_bench_ocp(N=N, n_paths=2)
    params, xinit, z_init, _ = jbench.build_tmpc_fleet(jo, js, batch,
                                                       seed=seed,
                                                       dtype=np.float64)
    idx = jo.registry.save_map()
    params[..., idx["consistency_weight"]] = 0.05
    params[..., idx["prev_traj_x"]] = z_init[:, :, :N, 2] + 0.1
    params[..., idx["prev_traj_y"]] = z_init[:, :, :N, 3] - 0.2
    B, P = params.shape[:2]
    Pf = params.reshape(B * P, N, -1)
    x0 = np.repeat(xinit, P, axis=0)
    Z = z_init.reshape(B * P, N + 1, -1)
    if perturb:
        rng = np.random.default_rng(3)
        Z = Z + 0.05 * rng.normal(size=Z.shape)
        x0 = x0 + 0.01 * rng.normal(size=x0.shape)
    Pt = np.concatenate([Pf, Pf[:, -1:]], axis=1)
    lanes = (np.ascontiguousarray(np.transpose(Pt, (2, 1, 0))),
             np.ascontiguousarray(np.transpose(Z, (1, 2, 0))),
             np.ascontiguousarray(x0.T))
    return jo, to, (Pf, x0, Z), lanes


def test_solve_qp_lanes_matches_interpreted_kernel():
    """random_qp instances (T=6, 4 generic rows, 2 box rows, one QP
    tightened) in LaneQP layouts, 8 iterations."""
    raws, meta = [], None
    for seed, tighten in ((0, 0.0), (7, 0.5)):
        H, g, A, B, c, D, e, mask, r0 = random_qp(seed, T=6, m=4)[1]
        e = np.where(mask > 0, e - tighten, e)
        raw, meta = _with_box_rows((H, g, A, B, c, D, e, mask, r0), seed, 2)
        raws.append(raw)
    H, g, A, B, c, D, e, mask, r0 = [np.stack([raw[i] for raw in raws], -1)
                                     for i in range(9)]
    generic = [r for r, m in enumerate(meta) if m[0] == "h"]
    lane = (H, g, A, B, c, D[:, generic], e, r0)
    stage_mask = mask[..., 0]
    want = np.asarray(jax_lanes(
        jlin.LaneQP(*map(jnp.asarray, lane)), stage_mask, nu=2, n_iters=8,
        interpret=True, row_meta=meta))
    n0 = qp_cuda.lanes_launches
    got = qp_cuda.solve_qp_lanes(
        linearize.LaneQP(*map(torch.as_tensor, lane)), stage_mask, nu=2,
        n_iters=8, row_meta=meta)
    assert qp_cuda.lanes_launches == n0  # the CPU path launches no kernel
    assert got.shape == want.shape == (6, 5, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def bench6():
    return _lane_inputs(N=6, batch=2)


def test_lane_linearizer_and_merit_match_jax(bench6):
    """N=6, bench widths: every LaneQP field and the merit terms of the
    port's lane linearizer (torch.func on the CPU) vs the JAX package's."""
    jo, to, _, lanes = bench6
    jcfg, tcfg = jsqp.SQPConfig(**CFG), tsqp.SQPConfig(**CFG)
    want = jlin.make_lane_linearizer(jo, jcfg, jnp.float64)(
        *map(jnp.asarray, lanes))
    want_m = jlin.make_lane_merit(jo, jcfg, jnp.float64)(
        *map(jnp.asarray, lanes))
    tl = tuple(map(torch.as_tensor, lanes))
    got = linearize.make_lane_linearizer(to, tcfg, dtype=F64,
                                         device="cpu")(*tl)
    got_m = linearize.make_lane_merit(to, tcfg, dtype=F64, device="cpu")(*tl)
    for name, a, b in zip(linearize.LaneQP._fields, got, want):
        assert a.dtype == F64, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res", "finite"), got_m,
                          want_m):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9, err_msg=name)


def test_solve_qp_fields_matches_lanes_on_linearizer_output(bench6):
    """The route the lane fleet takes (the linearizer's QPFields straight
    into solve_qp_fields) vs solve_qp_lanes on the same QP as a LaneQP."""
    _, to, _, lanes = bench6
    lin = linearize.make_lane_linearizer(to, tsqp.SQPConfig(**CFG), dtype=F64,
                                         device="cpu")
    tl = tuple(map(torch.as_tensor, lanes))
    fields, _ = lin.fields(*tl)
    T, nz, B = tl[1].shape
    kw = dict(nu=2, n_iters=8, mu_min=1e-6, w_max=1e6,
              row_meta=lin.machinery.row_meta)
    stage_mask = lin.machinery.stage_mask
    z_fields = qp_cuda.solve_qp_fields(fields, stage_mask, **kw)
    z_lanes = qp_cuda.solve_qp_lanes(linearize.lane_qp(fields, T), stage_mask,
                                     **kw)
    assert z_fields.shape == (T * nz, B)
    np.testing.assert_allclose(z_fields.reshape(T, nz, B).numpy(),
                               z_lanes.numpy(), rtol=0, atol=1e-12)
    assert np.abs(z_lanes.numpy()).max() > 1e-3


@pytest.mark.parametrize("track_best", [False, True])
def test_lanes_backend_matches_pallas_backend(track_best, bench6):
    """The whole lane path on the CPU vs the per-iteration path's plain
    version, N=6, 2 plans x 3 planners, the bench schedule: the same QPs and
    the same IP iteration, so equal to 1e-9 relative; no kernel launches."""
    _, to, (P, x0, Z), _ = bench6
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=8, track_best=track_best,
                         qp_iter_schedule=BENCH_SCHEDULE, **CFG)
    n0 = (qp_cuda.launches + qp_cuda.lanes_launches
          + sqp_fused.linearize_launches + sqp_fused.merit_launches)
    out = {b: tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                         backend=b)(P, x0, Z)
           for b in ("lanes", "pallas")}
    assert n0 == (qp_cuda.launches + qp_cuda.lanes_launches
                  + sqp_fused.linearize_launches + sqp_fused.merit_launches)
    a, b = out["lanes"], out["pallas"]
    assert a.success.float().mean().item() >= 0.5
    np.testing.assert_array_equal(a.success.numpy(), b.success.numpy())
    np.testing.assert_allclose(a.z.numpy(), b.z.numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(a.cost.numpy(), b.cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(a.eq_res.numpy(), b.eq_res.numpy(), rtol=1e-9,
                               atol=1e-14)
    assert a.z.shape == Z.shape and a.z.is_contiguous()


def test_lanes_backend_raises_for_uncovered_ocp():
    """Where the JAX package warns and falls back to the per-iteration path,
    the port raises when the solver is built. "mirror" is covered: its
    linearization mirrors the Hessians (the mirror linearize entry)."""
    to, _ = tbench.tmpc_bench_ocp(N=3, n_paths=2)
    solve = tsqp.make_fleet_sqp_solver(
        to, tsqp.SQPConfig(regularization="mirror"), dtype=F64, device="cpu",
        backend="lanes")
    assert solve.tables.reg == sqp_fused.REG_MIRROR
    # the dynamic velocity reference without the PathReferenceVelocity
    # module's spline parameters
    for module in to.modules:
        if hasattr(module, "dynamic_velocity_reference"):
            module.dynamic_velocity_reference = True
    with pytest.raises(NotImplementedError, match="dynamic_velocity"):
        tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**CFG), dtype=F64,
                                   device="cpu", backend="lanes")
    # topology halfspaces over two discs
    to, _ = tbench.tmpc_bench_ocp(N=3, n_paths=2)
    for module in to.modules:
        topo = getattr(module, "topology_constraints", None)
        if topo is not None:
            topo.n_discs = 2
    with pytest.raises(NotImplementedError, match="single-disc"):
        tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**CFG), dtype=F64,
                                   device="cpu", backend="lanes")
    # with the module, the dynamic velocity reference is covered
    to, _ = tbench.tmpc_bench_ocp(N=3, n_paths=2,
                                  dynamic_velocity_reference=True)
    tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**CFG), dtype=F64,
                               device="cpu", backend="lanes")


@pytest.mark.slow
def test_lanes_backend_matches_jax_lanes_interpret():
    """N=4, 1 plan x 3 planners, the bench schedule: the port's lane path vs
    the JAX lane path with the Pallas kernel in interpret mode (the same
    algorithm): same success mask, Z and cost within atol 1e-8."""
    jo, to, (P, x0, Z), _ = _lane_inputs(N=4, batch=1, perturb=False)
    kw = dict(n_sqp=4, n_qp_iter=8, track_best=False,
              qp_iter_schedule=BENCH_SCHEDULE, **CFG)
    ref = jsqp.make_fleet_sqp_solver(
        jo, jsqp.SQPConfig(**kw), dtype=jnp.float64, backend="lanes",
        interpret=True)(*map(jnp.asarray, (P, x0, Z)))
    out = tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**kw), dtype=F64,
                                     device="cpu", backend="lanes")(P, x0, Z)
    np.testing.assert_array_equal(out.success.numpy(), np.asarray(ref.success))
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=0, atol=1e-8)
