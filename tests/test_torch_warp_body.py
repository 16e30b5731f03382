"""The kernels' per-problem code, one lane group per problem, run on the host.

``csrc/tmpc_ocp_host.cpp`` compiles the QP kernel's and the fused kernel's
per-problem code (``qp_ip.cuh``, ``tmpc_ocp.cuh``, ``sqp_fused.cuh``) with a
plain C++ compiler; each problem runs on 32 emulated lanes (``warp.cuh``),
phase after phase, so the host executes the card's partition of the work in
the card's reduction order.

- The QP entries (cold; duals out; warm from given duals) against the plain
  version ``ip_solve_reference`` at f64 on the bench QPs (T=21, m=22, the
  bench rows), and with every row masked. Tolerance 1e-9 (1 + max|ref|): the
  card's f64 gate (1e-8) tightened by 10, since the host runs the same
  sums in the same order and differs from the plain version only by the
  plain version's own summation order.
- The fused kernel's whole solve against ``fused_fleet_reference`` at f64
  (the card's gate, 1e-6 per problem, and the same success mask).
- The linearize entry's lane form (lane t linearizes stage t) against the
  header's serial stage-after-stage form at N=20: the same per-stage code, so
  bit for bit.
- An (nx, nu) the kernels are not compiled for raises ``ValueError`` in the
  launch path the CUDA wrappers share.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    _make_machinery, make_fleet_sqp_solver)
from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (  # noqa: E402
    bench_config, bench_fleet)

from test_qp import random_qp  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


@pytest.fixture(scope="module")
def bench():
    """The bench OCP, 2 plans x 9 planners at f64, the machinery, and the
    linearization point: P (stage N repeating N-1), x0, Z."""
    ocp, (params, xinit, z_init, _) = bench_fleet(2, F64, "cpu")
    cfg = bench_config()
    mach = _make_machinery(ocp, cfg, F64, "cpu")
    B, Pn = params.shape[:2]
    P = params.reshape(B * Pn, *params.shape[2:])
    P = torch.cat([P, P[:, -1:]], dim=1)
    x0 = xinit.repeat_interleave(Pn, dim=0)
    Z = z_init.reshape(B * Pn, *z_init.shape[2:])
    return ocp, cfg, mach, P, x0, Z


def _kw(mach, cfg, n_iters):
    return dict(nu=mach.nu, n_iters=n_iters, mu_min=cfg.mu_min,
                w_max=cfg.w_max, row_meta=mach.row_meta)


def _fields(qp, mach):
    rows = qp_cuda._rows(mach.stage_mask, mach.row_meta, qp.g.shape[1],
                         qp.D.shape[2])
    return qp_cuda._batch_fields(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                                 qp.r0, rows)


def _close(got, want, name):
    """max|got - want| <= 1e-9 (1 + max|want|), want batch-major."""
    want = want.reshape(want.shape[0], -1).t()
    assert got.shape == want.shape, name
    err = (got - want).abs().max().item()
    bound = 1e-9 * (1.0 + want.abs().max().item())
    assert err <= bound, (name, err, bound)


def test_host_qp_cold_matches_plain_at_bench_shape(host, bench):
    _, cfg, mach, P, x0, Z = bench
    qp = mach.build_qp(Z, P, x0)
    assert qp.g.shape[1:] == (21, 7) and qp.D.shape[2] == 22
    kw = _kw(mach, cfg, 8)
    launches = qp_cuda.launches
    z = qp_cuda.host_solve_qp_fields(_fields(qp, mach), mach.stage_mask, **kw)
    assert qp_cuda.launches == launches  # no kernel launch is counted
    want = qp_cuda.ip_solve_reference(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D,
                                      qp.e, mach.stage_mask, qp.r0, **kw)
    assert torch.isfinite(z).all()
    _close(z, want, "z")


def test_host_qp_duals_and_warm_match_plain_at_bench_shape(host, bench):
    """Cold with duals out, then warm from them on the QPs re-linearized
    after the step, as the dual-warm fleet path runs them."""
    _, cfg, mach, P, x0, Z = bench
    qp = mach.build_qp(Z, P, x0)
    args = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask, qp.r0)
    kw = _kw(mach, cfg, 8)
    z, lam = qp_cuda.host_solve_qp_fields(_fields(qp, mach), mach.stage_mask,
                                          duals_out=True, **kw)
    z_p, lam_p = qp_cuda.ip_solve_reference(*args, duals_out=True, **kw)
    _close(z, z_p, "cold z")
    _close(lam, lam_p, "cold lam")
    qp1 = mach.build_qp(Z + z_p, P, x0)
    kw = _kw(mach, cfg, 6)
    z, lam = qp_cuda.host_solve_qp_fields(
        _fields(qp1, mach), mach.stage_mask, duals_out=True,
        lam0=qp_cuda._lanes(lam_p, lam_p.shape[0]), **kw)
    z_p, lam_w = qp_cuda.ip_solve_reference(
        qp1.H, qp1.g, qp1.A, qp1.B, qp1.c, qp1.D, qp1.e, mach.stage_mask,
        qp1.r0, duals_out=True, lam0=lam_p, **kw)
    _close(z, z_p, "warm z")
    _close(lam, lam_w, "warm lam")


def test_host_qp_without_active_rows_matches_plain(host, bench):
    """Every row masked: one exact Riccati solve, multipliers 0."""
    _, cfg, mach, P, x0, Z = bench
    qp = mach.build_qp(Z, P, x0)
    mask = np.zeros_like(mach.stage_mask)
    kw = _kw(mach, cfg, 8)
    rows = qp_cuda._rows(mask, mach.row_meta, 21, 22)
    fields = qp_cuda._batch_fields(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                                   qp.r0, rows)
    z, lam = qp_cuda.host_solve_qp_fields(fields, mask, duals_out=True, **kw)
    want = qp_cuda.ip_solve_reference(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D,
                                      qp.e, mask, qp.r0, **kw)
    _close(z, want, "z")
    assert torch.equal(lam, torch.zeros_like(lam))


@pytest.mark.parametrize("track_best", [False, True])
def test_host_fused_solve_matches_plain(host, bench, track_best):
    ocp, cfg, _, P, x0, Z = bench
    solve = make_fleet_sqp_solver(ocp, cfg._replace(track_best=track_best),
                                  dtype=F64, device="cpu", backend="fused")
    launches = sqp_fused.launches
    got = solve.host(P[:, :-1], x0, Z)
    assert sqp_fused.launches == launches
    want = solve(P[:, :-1], x0, Z)
    assert bool((got.success == want.success).all())
    rel = ((got.z - want.z).abs().amax(dim=(1, 2))
           / (1.0 + want.z.abs().amax(dim=(1, 2))))
    assert rel.max().item() <= 1e-6
    np.testing.assert_allclose(got.cost.numpy(), want.cost.numpy(),
                               rtol=1e-6, atol=1e-9)


def test_lane_linearization_matches_serial_header(host, bench):
    """N=20: every QP field and the merit terms of the linearize entry's
    lane form against the header stage after stage."""
    ocp, cfg, _, P, x0, Z = bench
    tables = sqp_fused.ocp_tables(ocp, cfg)
    assert tables.T == 21
    rng = np.random.default_rng(3)
    Zp = Z + 0.05 * torch.as_tensor(rng.normal(size=tuple(Z.shape)))
    serial = sqp_fused.host_linearize(tables, P, x0, Zp)
    lanes = sqp_fused.host_linearize(tables, P, x0, Zp, lanes=True)
    for name, a, b in zip(sqp_fused.QPData._fields, lanes[0], serial[0]):
        assert torch.equal(a, b), name
    for name, a, b in zip(("merit", "cost", "eq_res"), lanes[1:], serial[1:]):
        assert torch.equal(a, b), name
    assert torch.isfinite(serial[2]).all() and (serial[3] > 0).all()


def test_uninstantiated_sizes_raise_value_error(host):
    """(nx, nu) = (3, 1): the launch path the CUDA wrappers share raises
    before it touches a device; the plain version still solves it."""
    with pytest.raises(ValueError, match=r"not \(3, 1\)"):
        qp_cuda.check_instantiated(3, 1)
    qp_cuda.check_instantiated(5, 2)
    H, g, A, B, c, D, e, mask, r0 = (torch.as_tensor(np.asarray(x))[None]
                                     for x in random_qp(0, nx=3, nu=1)[1])
    rows = qp_cuda._rows(mask[0], None, g.shape[1], D.shape[2])
    fields = qp_cuda._batch_fields(H, g, A, B, c, D, e, r0, rows)
    with pytest.raises(ValueError, match="compiled for"):
        qp_cuda.host_solve_qp_fields(fields, mask[0], nu=1)
    z = qp_cuda.solve_qp_batched(H, g, A, B, c, D, e, mask[0], r0, nu=1)
    assert torch.isfinite(z).all()
