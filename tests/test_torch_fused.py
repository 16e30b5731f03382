"""The port's fused whole-SQP path (kernel B2) against torch.func and the JAX
package, on the CPU at float64.

- The kernel's linearization header ``csrc/tmpc_ocp.cuh`` compiled for the
  host with a C++ compiler (``sqp_fused.host_linearize``): every QP field and
  the merit terms at N=20, the bench widths, against the port's ``build_qp``
  / ``merit_of`` (torch.func; rtol 1e-9, atol 1e-10) and against the JAX
  package's lane linearizer (``ops/linearize.py``, plain JAX on the CPU;
  atol 1e-9: JAX's atan2 is a Newton-polished rational, torch's is libm).
  Skipped only where no C++ compiler is found.
- ``fused_fleet_reference`` (the kernel's plain version, which the fused
  backend runs on CPU tensors) against the per-iteration ``"pallas"`` path:
  the same SQP, the same QPs, so equal to round-off.
- What the fused backend does not cover raises; it never falls back.
- The repairs: ``levenberg`` / ``none`` regularization, ``qp_comp`` and
  ``exit_code`` in ``SQPResult``, and build hashes over every header.
- Slow: the fused path against the JAX fused Pallas kernel in interpret mode.

The CUDA kernel itself is held against these plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as jbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.linearize import (  # noqa: E402
    make_lane_linearizer, make_lane_merit)

from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.models import (  # noqa: E402
    ContouringSecondOrderUnicycleModel)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (  # noqa: E402
    make_batched_tmpc_step)

F64 = torch.float64
BENCH_SCHEDULE = ((1, 3), (1, 5), (2, 8))


def _fleet(N, batch, n_paths=2, max_obstacles=4, seed=0, perturb=True):
    """Bench OCPs of both packages and one f64 fleet, flattened to B*P
    problems: P (B*P, N, npar), x0 (B*P, nx), Z (B*P, N+1, nvar). The
    consistency cost is on (weight 0.05 toward a shifted warm start), and
    with ``perturb`` the iterate and x0 move off the warm start, so that
    every term and the dynamics defects are nonzero."""
    jo, js = jbench.tmpc_bench_ocp(N=N, n_paths=n_paths,
                                   max_obstacles=max_obstacles)
    to, _ = tbench.tmpc_bench_ocp(N=N, n_paths=n_paths,
                                  max_obstacles=max_obstacles)
    params, xinit, z_init, _ = jbench.build_tmpc_fleet(
        jo, js, batch, seed=seed, dtype=np.float64)
    idx = jo.registry.save_map()
    params[..., idx["consistency_weight"]] = 0.05
    params[..., idx["prev_traj_x"]] = z_init[:, :, :N, 2] + 0.1
    params[..., idx["prev_traj_y"]] = z_init[:, :, :N, 3] - 0.2
    B, P = params.shape[:2]
    Pf = params.reshape(B * P, N, -1)
    x0 = np.repeat(xinit, P, axis=0)
    Z = z_init.reshape(B * P, N + 1, -1)
    if perturb:
        rng = np.random.default_rng(7)
        Z = Z + 0.05 * rng.normal(size=Z.shape)
        x0 = x0 + 0.01 * rng.normal(size=x0.shape)
    return jo, to, Pf, x0, Z


def _with_terminal(P):
    return np.concatenate([P, P[:, -1:]], axis=1)


@pytest.fixture(scope="module")
def host_lin():
    """The header built for the host (skips without a C++ compiler)."""
    if sqp_fused.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    sqp_fused.build_host()
    return sqp_fused.host_linearize


@pytest.fixture(scope="module")
def bench20():
    return _fleet(N=20, batch=2)


@pytest.mark.parametrize("reg", ["gershgorin", "levenberg", "none"])
def test_header_matches_build_qp(reg, host_lin, bench20):
    """N=20, bench widths: every QP field and (merit, cost, eq_res) of the
    host-compiled header vs the port's torch.func build_qp / merit_of, with
    the kernel's stage-N placeholders (generic D rows 0, e 1)."""
    _, to, P, x0, Z = bench20
    cfg = tsqp.SQPConfig(regularization=reg, reg_eps=1e-4, levenberg=2e-3)
    tables = sqp_fused.ocp_tables(to, cfg)
    mach = tsqp._make_machinery(to, cfg, F64, "cpu")
    Pt = _with_terminal(P)
    got = host_lin(tables, Pt, x0, Z)
    want = sqp_fused.linearize_reference(
        mach, tables, *(torch.as_tensor(a) for a in (Pt, x0, Z)))
    for name, a, b in zip(tsqp.QPData._fields, got[0], want[0]):
        assert a.dtype == F64 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    # Stage N rows are masked placeholders; the body rows are build_qp's own.
    full = mach.build_qp(*(torch.as_tensor(a) for a in (Z, Pt, x0)))
    np.testing.assert_allclose(got[0].D[:, :-1].numpy(),
                               full.D[:, :-1].numpy(), rtol=1e-9, atol=1e-10)
    assert float(mach.stage_mask[-1].max()) == 0.0


def test_header_matches_jax_lane_linearizer(host_lin, bench20):
    """N=20, bench widths: the header vs the JAX package's
    ``make_lane_linearizer`` / ``make_lane_merit`` (the functions the JAX
    fused kernel traces), field by field in their lane layout, atol 1e-9."""
    jo, to, P, x0, Z = bench20
    cfg = dict(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, tsqp.SQPConfig(**cfg))
    Pt = _with_terminal(P)
    qp, merit, cost, eq_res = host_lin(tables, Pt, x0, Z)

    jcfg = jsqp.SQPConfig(**cfg)
    lanes = (jnp.asarray(np.transpose(Pt, (2, 1, 0))),
             jnp.asarray(np.transpose(Z, (1, 2, 0))), jnp.asarray(x0.T))
    lq = make_lane_linearizer(jo, jcfg, jnp.float64)(*lanes)
    lm = make_lane_merit(jo, jcfg, jnp.float64)(*lanes)
    ours = {
        "H": qp.H, "g": qp.g, "A": qp.A, "B": qp.B, "c": qp.c,
        "D": qp.D[:, :, list(tables.generic)], "e": qp.e, "r0": qp.r0}
    for name, want in zip(lq._fields, lq):
        want = np.moveaxis(np.asarray(want), -1, 0)
        np.testing.assert_allclose(ours[name].numpy(), want, rtol=0,
                                   atol=1e-9, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), (merit, cost, eq_res),
                          lm[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9, err_msg=name)


def test_qp_layout_matches_header(host_lin):
    """The Python unpacking offsets are the header's ``QpLayout``."""
    import ctypes

    lib = ctypes.CDLL(sqp_fused.build_host())
    for T, m, mh in ((21, 22, 8), (5, 14, 0), (2, 3, 3)):
        out = (ctypes.c_int * 9)()
        lib.tmpc_qp_layout(T, m, mh, out)
        lay = sqp_fused.qp_layout(T, m, mh)
        assert list(out) == [lay[k] for k in ("H", "g", "A", "B", "c", "D",
                                              "e", "r0", "total")]


@pytest.mark.parametrize("track_best", [False, True])
def test_fused_step_matches_pallas_plain_path(track_best):
    """The whole slice on the CPU: ``make_batched_tmpc_step(backend=
    "fused")`` (which runs ``fused_fleet_reference``) vs the per-iteration
    ``"pallas"`` path's plain version, N=6, B=2 plans x 3 planners, the
    bench operating point. The same QPs and the same IP iteration: equal to
    round-off (atol 1e-12); no kernel is launched."""
    _, to, P, x0, Z = _fleet(N=6, batch=2, perturb=False)
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                         reg_eps=1e-4, regularization="gershgorin",
                         track_best=track_best,
                         qp_iter_schedule=BENCH_SCHEDULE)
    args = (P.reshape(2, 3, *P.shape[1:]), x0[::3],
            Z.reshape(2, 3, *Z.shape[1:]), np.zeros((2, 3), dtype=bool))
    n0 = qp_cuda.launches + sqp_fused.launches
    out = {backend: make_batched_tmpc_step(to, cfg, dtype=F64, device="cpu",
                                           backend=backend)(*args)
           for backend in ("fused", "pallas")}
    assert qp_cuda.launches + sqp_fused.launches == n0
    a, b = out["fused"], out["pallas"]
    assert a.all_success.float().mean().item() >= 0.5
    np.testing.assert_array_equal(a.all_success.numpy(), b.all_success.numpy())
    np.testing.assert_array_equal(a.best_index.numpy(), b.best_index.numpy())
    np.testing.assert_allclose(a.best_z.numpy(), b.best_z.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(a.all_costs.numpy(), b.all_costs.numpy(),
                               rtol=0, atol=1e-12)


def test_fused_reference_keeps_iterate_on_nan_step():
    """A problem whose QP step is NaN keeps its iterate (the fused NaN guard
    on the sum of dz); the others move. One NaN parameter poisons only its
    own problem."""
    _, to, P, x0, Z = _fleet(N=4, batch=1, perturb=False)
    P = P.copy()
    idx = to.registry.save_map()
    P[1, :, idx["contour"]] = np.nan
    cfg = tsqp.SQPConfig(n_sqp=2, n_qp_iter=6, mu_min=1e-6, w_max=1e6,
                         regularization="gershgorin", track_best=False)
    res = tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                     backend="fused")(P, x0, Z)
    np.testing.assert_array_equal(res.z[1].numpy(), Z[1])
    assert not bool(res.success[1]) and bool(res.success[0])
    assert not np.allclose(res.z[0].numpy(), Z[0])


def _bench_ocp():
    to, _ = tbench.tmpc_bench_ocp(N=4, n_paths=2)
    return to


def _other_model(ocp):
    @dataclasses.dataclass(frozen=True)
    class OtherModel(ContouringSecondOrderUnicycleModel):
        name: str = "other"

    return dataclasses.replace(ocp, model=OtherModel())


def _dynamic_velocity(ocp):
    from oscar_mpc_planner_mr_modification_tpu_torch.modules import (
        ContouringModule)

    for module in ocp.modules:
        if isinstance(module, ContouringModule):
            module.dynamic_velocity_reference = True
    return ocp


def _two_modes(ocp):
    for module in ocp.modules:
        sub = getattr(module, "constraint_submodule", None)
        if sub is not None:
            sub.max_modes = 2
    return ocp


@pytest.mark.parametrize("case,error", [
    ("mirror", ValueError), ("unknown_regularization", ValueError),
    ("other_model", NotImplementedError),
    ("dynamic_velocity_reference", NotImplementedError),
    ("two_modes", NotImplementedError), ("unknown_backend", ValueError)])
def test_uncovered_raises(case, error):
    """The fused backend raises when it is built for what its kernel does not
    cover; it does not fall back to the per-iteration path."""
    ocp = _bench_ocp()
    cfg = tsqp.SQPConfig(regularization="gershgorin")
    backend = "fused"
    if case == "mirror":
        cfg = cfg._replace(regularization="mirror")
    elif case == "unknown_regularization":
        cfg = cfg._replace(regularization="eigen")
    elif case == "other_model":
        ocp = _other_model(ocp)
    elif case == "dynamic_velocity_reference":
        ocp = _dynamic_velocity(ocp)
    elif case == "two_modes":
        ocp = _two_modes(ocp)
    else:
        backend = "mosaic"
    with pytest.raises(error):
        make_batched_tmpc_step(ocp, cfg, dtype=F64, device="cpu",
                               backend=backend)


REPAIR_REGS = ("levenberg", "none")


@pytest.fixture(scope="module")
def jax_repair_qps():
    """JAX ``_make_machinery.build_qp`` under each repaired regularization,
    compiled as one program, N=3."""
    jo, to, P, x0, Z = _fleet(N=3, batch=1)
    Pt = _with_terminal(P)
    machs = [jsqp._make_machinery(
        jo, jsqp.SQPConfig(regularization=reg, levenberg=2e-3), jnp.float64)
        for reg in REPAIR_REGS]
    qps = jax.jit(lambda z, p, x: tuple(jax.vmap(m.build_qp)(z, p, x)
                                        for m in machs))(
        jnp.asarray(Z), jnp.asarray(Pt), jnp.asarray(x0))
    return to, (Z, Pt, x0), dict(zip(REPAIR_REGS, qps))


@pytest.mark.parametrize("reg", REPAIR_REGS)
def test_repair_regularizations_match_jax(reg, jax_repair_qps):
    """``levenberg`` (H + levenberg I) and ``none`` in the port's build_qp vs
    the JAX package's ``_make_machinery.build_qp``, atol 1e-9."""
    to, args, jqps = jax_repair_qps
    tm = tsqp._make_machinery(
        to, tsqp.SQPConfig(regularization=reg, levenberg=2e-3), F64, "cpu")
    tq = tm.build_qp(*(torch.as_tensor(a) for a in args))
    for name in tsqp.QPData._fields:
        np.testing.assert_allclose(getattr(tq, name).numpy(),
                                   np.asarray(getattr(jqps[reg], name)),
                                   rtol=0, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_repair_sqp_result_fields(backend):
    """SQPResult carries the JAX fields in the JAX order; on the fleet paths
    ``qp_comp`` is 0 and ``exit_code`` is 1 on success, 0 otherwise."""
    assert tsqp.SQPResult._fields == jsqp.SQPResult._fields
    _, to, P, x0, Z = _fleet(N=4, batch=1, perturb=False)
    cfg = tsqp.SQPConfig(n_sqp=2, n_qp_iter=6, mu_min=1e-6, w_max=1e6,
                         regularization="gershgorin", res_eq_tol=1e-6)
    res = tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                     backend=backend)(P, x0, Z)
    assert torch.equal(res.qp_comp, torch.zeros_like(res.cost))
    assert torch.equal(res.exit_code, res.success.to(res.exit_code.dtype))
    assert res.exit_code.dtype == torch.int32


def test_repair_build_hash_covers_headers(tmp_path):
    """A kernel library is keyed on its source AND every header beside it,
    so that an edited header is never served by a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(qp_cuda._CSRC, csrc)
    srcs = {name: csrc / src for name, src in qp_cuda.KERNELS.items()}
    before = {name: qp_cuda._digest(src) for name, src in srcs.items()}
    for header, touched in (("qp_ip.cuh", ("qp_ip", "sqp_fused")),
                            ("tmpc_ocp.cuh", ("sqp_fused",))):
        path = csrc / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {name: qp_cuda._digest(src) for name, src in srcs.items()}
        for name in touched:
            assert after[name] != before[name], (header, name)
        before = after
    assert qp_cuda._digest(srcs["qp_ip"]) != qp_cuda._digest(
        srcs["qp_ip"], flags=("-O2",))


@pytest.mark.slow
def test_fused_matches_jax_fused_interpret():
    """The port's fused path on the CPU vs the JAX package's fused Pallas
    kernel in interpret mode (``make_fleet_sqp_solver(backend="fused",
    interpret=True)``), set up as ``tests/test_fused_flavors.py`` does: N=4,
    2+1 planners, 3 obstacles, f64. Identical success mask; Z and cost
    within atol 1e-8."""
    jo, to, P, x0, Z = _fleet(N=4, batch=2, max_obstacles=3, perturb=False)
    kw = dict(n_sqp=4, n_qp_iter=8, mu_min=1e-10, regularization="gershgorin",
              track_best=False, qp_iter_schedule=((2, 6), (2, 12)))
    ref = jsqp.make_fleet_sqp_solver(
        jo, jsqp.SQPConfig(**kw), dtype=jnp.float64, backend="fused",
        interpret=True)(*map(jnp.asarray, (P, x0, Z)))
    out = tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**kw), dtype=F64,
                                     device="cpu", backend="fused")(P, x0, Z)
    np.testing.assert_array_equal(out.success.numpy(), np.asarray(ref.success))
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=0, atol=1e-8)
