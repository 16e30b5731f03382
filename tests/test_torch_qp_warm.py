"""The port's dual variants of the interior-point QP (the plain version of
the Hopper kernel's ``qp_ip_solve_duals`` entry) and the dual-warm fleet
path, against the JAX package on the CPU at float64.

- ``solve_qp_batched_duals`` cold with duals out, then warm from those duals
  on the same and on a perturbed QP, against the JAX Pallas kernel's
  ``solve_qp_batched_duals`` in interpret mode: the same algorithm on the
  same inputs, so z and lam agree to atol 1e-8.
- The warm freeze: with carried duals the complementarity is tiny at
  z = 0, and the first iteration must still move.
- m == 0 has no duals: both packages raise ``ValueError``.
- ``make_fleet_sqp_solver(backend="pallas")`` with ``n_qp_iter_warm`` against
  the JAX ``backend="xla"`` fleet at converged QP solves, with the
  tolerances of the JAX suite's own dual-warm check (atol 2e-4 on z, rtol
  1e-5 on the cost).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as jbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.qp_pallas import (  # noqa: E402
    solve_qp_batched_duals as jax_duals)
from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JaxSQPConfig, make_fleet_sqp_solver as jax_fleet)
from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPConfig, make_fleet_sqp_solver)

from test_qp import random_qp  # noqa: E402
from test_torch_qp_kernel import _with_box_rows  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module")
def qps():
    """Two random_qp instances (T=6, nx=3, nu=2, 4 generic rows) with two
    box rows, one tightened so that z = 0 violates rows."""
    raws = []
    for seed, tighten in ((0, 0.0), (7, 0.5)):
        H, g, A, B, c, D, e, mask, r0 = random_qp(seed, T=6, m=4)[1]
        e = np.where(mask > 0, e - tighten, e)
        raw, meta = _with_box_rows((H, g, A, B, c, D, e, mask, r0), seed, 2)
        raws.append(raw)
    batch = [np.stack([raw[i] for raw in raws]) for i in range(9)]
    return batch, meta


def _both(batch, meta, n_iters, lam0=None):
    mask = batch[7][0]
    zj, lj = jax_duals(
        *[jnp.asarray(x) for x in batch[:7]], mask, jnp.asarray(batch[8]),
        nu=2, n_iters=n_iters, interpret=True, row_meta=meta,
        lam0=None if lam0 is None else jnp.asarray(lam0))
    zt, lt = qp_cuda.solve_qp_batched_duals(
        *[torch.as_tensor(x) for x in batch[:7]], mask,
        torch.as_tensor(batch[8]), nu=2, n_iters=n_iters, row_meta=meta,
        lam0=None if lam0 is None else torch.as_tensor(lam0))
    assert zt.dtype == F64 and lt.shape == batch[6].shape
    return (np.asarray(zj), np.asarray(lj)), (zt.numpy(), lt.numpy())


def test_duals_cold_and_warm_match_interpreted_kernel(qps):
    batch, meta = qps
    n0 = qp_cuda.duals_launches
    (zj, lj), (zt, lt) = _both(batch, meta, n_iters=8)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-8)
    assert (lt >= 0).all() and np.isfinite(lt).all()
    # Rows masked at a stage carry no multiplier there.
    assert (lt[:, batch[7][0] == 0] == 0).all()
    # Warm from those duals on a perturbed QP (a re-linearization).
    warm = list(batch)
    warm[1] = batch[1] + 0.05
    warm[6] = batch[6] + np.where(batch[7] > 0, 0.02, 0.0)
    (zj, lj), (zt, lt) = _both(warm, meta, n_iters=4, lam0=lj)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-8)
    assert qp_cuda.duals_launches == n0  # the CPU path launches no kernel


def test_warm_start_runs_one_iteration_before_freezing(qps):
    """Warm from the converged duals of the same QP (the f64 constants of
    the JAX suite's warm-start check): complementarity is below the freeze
    tolerance at z = 0, yet one warm iteration moves z, and 10 warm
    iterations reach the 30-iteration cold solution."""
    batch, meta = qps
    args = ([torch.as_tensor(x) for x in batch[:7]], batch[7][0],
            torch.as_tensor(batch[8]))
    kw = dict(nu=2, row_meta=meta, mu_min=1e-11, w_max=1e14, s_floor=1e-12,
              tol_freeze=1e-10)
    z_cold, lam = qp_cuda.solve_qp_batched_duals(*args[0], args[1], args[2],
                                                 n_iters=30, **kw)
    z1, _ = qp_cuda.solve_qp_batched_duals(*args[0], args[1], args[2],
                                           n_iters=1, lam0=lam, **kw)
    assert float(z1.abs().max()) > 0.0
    z_warm, _ = qp_cuda.solve_qp_batched_duals(*args[0], args[1], args[2],
                                               n_iters=10, lam0=lam, **kw)
    np.testing.assert_allclose(z_warm.numpy(), z_cold.numpy(), atol=1e-4)


def test_duals_reject_zero_rows():
    H, g, A, B, c, _, _, _, r0 = random_qp(3)[1]
    T, nz = g.shape
    args = [np.asarray(x)[None] for x in (H, g, A, B, c)]
    no_rows = (np.zeros((1, T, 0, nz)), np.zeros((1, T, 0)))
    with pytest.raises(ValueError, match="m == 0"):
        jax_duals(*map(jnp.asarray, args + list(no_rows)), jnp.zeros((T, 0)),
                  jnp.asarray(r0)[None], nu=2, interpret=True)
    with pytest.raises(ValueError, match="m == 0"):
        qp_cuda.solve_qp_batched_duals(
            *map(torch.as_tensor, args + list(no_rows)), np.zeros((T, 0)),
            torch.as_tensor(r0)[None], nu=2)


def test_dual_warm_fleet_matches_jax_xla_backend():
    """N=3, 2+1 planners, B=2 plans (6 problems), f64, converged QP solves:
    6 SQP iterations, the first cold with 20 IP iterations, the rest warm
    with 12; the JAX XLA backend runs all six cold. Same success mask,
    z within atol 2e-4, cost within rtol 1e-5."""
    N = 3
    jo, js = jbench.tmpc_bench_ocp(N=N, n_paths=2)
    to, _ = tbench.tmpc_bench_ocp(N=N, n_paths=2)
    params, xinit, z_init, _ = jbench.build_tmpc_fleet(jo, js, 2, seed=0,
                                                       dtype=np.float64)
    B, P = params.shape[:2]
    args = (params.reshape(B * P, N, -1), np.repeat(xinit, P, axis=0),
            z_init.reshape(B * P, N + 1, -1))
    kw = dict(n_sqp=6, n_qp_iter=20, mu_min=1e-10,
              regularization="gershgorin")
    ref = jax_fleet(jo, JaxSQPConfig(**kw), dtype=jnp.float64,
                    backend="xla")(*map(jnp.asarray, args))
    n0 = qp_cuda.duals_launches + qp_cuda.launches
    out = make_fleet_sqp_solver(to, SQPConfig(n_qp_iter_warm=12, **kw),
                                dtype=F64, device="cpu")(*args)
    assert qp_cuda.duals_launches + qp_cuda.launches == n0
    assert out.success.float().mean().item() >= 0.5
    np.testing.assert_array_equal(out.success.numpy(), np.asarray(ref.success))
    np.testing.assert_allclose(out.z.numpy()[:, :-1], np.asarray(ref.z)[:, :-1],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-5, atol=1e-6)


def test_dual_warm_config_errors():
    to, _ = tbench.tmpc_bench_ocp(N=3, n_paths=2)
    warm = SQPConfig(n_qp_iter_warm=4, regularization="gershgorin")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_fleet_sqp_solver(to, warm._replace(qp_iter_schedule=((2, 4),)),
                              dtype=F64, device="cpu")
    for backend in ("fused", "lanes"):
        with pytest.raises(ValueError, match="n_qp_iter_warm"):
            make_fleet_sqp_solver(to, warm, dtype=F64, device="cpu",
                                  backend=backend)
