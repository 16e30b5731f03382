"""The port's stagewise QP solver (``ops/qp.py``) against the JAX package's,
on the CPU at f64, on random stagewise QPs (the generator of
tests/test_qp.py, copied here).

- ``solve_qp``: z, lam and s within rtol 1e-9 (atol 1e-12 for entries near
  zero) of JAX's, for nu = 1, 2, 3 (closed-form inverse) and 4 (Cholesky),
  on problems whose rows are all inactive at the optimum and on problems
  with active rows; one converged case runs into the freeze, where more
  iterations change nothing. Near the boundary an interior-point iteration
  amplifies round-off: on some random QPs JAX's own solve moves by 1e-7 to
  1 relative when g moves by 1e-15, and the two packages' sums, ordered
  differently, part as much. The cases are QPs on which JAX's solve is
  stable to that perturbation (checked here, 1e-10), so the tolerance
  tests the port and not the conditioning.
- ``solve_qp`` on two QPs where JAX's solve is not stable to that
  perturbation (its z, lam and s move by up to 2e-4 and 2e-3 relative):
  the port is held to measures that do not depend on the order of
  summation. Every row feasible within 1e-6, the equality residual
  (dynamics and initial condition, computed here from z) below 1e-12,
  complementarity within 2x JAX's, and the objective within rtol 1e-7 of
  JAX's.
- ``riccati_factor``: each of its four outputs (K, the factor of Quu, Qux,
  the value Hessian entering the next stage) within rtol 1e-12.
- The batch axis: problem i's result is the same whether it is solved
  alone or beside a NaN-poisoned problem.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops import qp as jqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp as tqp  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny tensor ops: one intra-op thread runs them fastest, and the
    suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_qp(seed, T=6, nx=3, nu=2, m=4, tighten=0.0):
    """tests/test_qp.py's generator (numpy fields in QPData order); with
    ``tighten`` > 0 the unconstrained optimum violates rows, so several are
    active at the optimum."""
    rng = np.random.default_rng(seed)
    nz = nu + nx
    H = np.zeros((T, nz, nz))
    for t in range(T):
        M = rng.normal(size=(nz, nz))
        H[t] = M @ M.T + 0.5 * np.eye(nz)
    H[-1, :nu, :] = 0.0
    H[-1, :, :nu] = 0.0
    H[-1, :nu, :nu] = np.eye(nu)
    g = rng.normal(size=(T, nz))
    g[-1, :nu] = 0.0
    A = rng.normal(size=(T - 1, nx, nx)) * 0.5
    B = rng.normal(size=(T - 1, nx, nu))
    c = rng.normal(size=(T - 1, nx)) * 0.1
    D = rng.normal(size=(T, m, nz))
    e = rng.uniform(0.5, 2.0, size=(T, m))
    mask = np.ones((T, m))
    D[-1] = 0.0
    e[-1] = 1.0
    mask[-1] = 0.0
    e = np.where(mask > 0, e - tighten, e)
    r0 = rng.normal(size=(nx,)) * 0.3
    return (H, g, A, B, c, D, e, mask, r0)


def jax_solve(raw, nu, **kw):
    return jqp.solve_qp(jqp.QPData(*map(jnp.asarray, raw)), nu=nu, **kw)


def torch_qp(*raws):
    """A batch of the given problems, stacked on the leading axis."""
    return tqp.QPData(*(torch.as_tensor(np.stack(f)) for f in zip(*raws)))


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def rel_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / (np.abs(b) + ATOL / RTOL)).max())


@pytest.mark.parametrize("seed,nu,tighten", [
    (0, 1, 0.0), (29, 1, 0.5), (6, 2, 0.0), (29, 2, 0.2), (13, 2, 0.3),
    (0, 3, 0.2), (12, 4, 0.5)],
    ids=["nu1", "nu1-active", "nu2", "nu2-active", "nu2-active-2",
         "nu3-active", "nu4-cholesky-active"])
def test_solve_qp_matches_jax(seed, nu, tighten):
    raw = random_qp(seed, nu=nu, tighten=tighten)
    kw = dict(n_iters=30, mu_min=1e-9)
    want = jax_solve(raw, nu, **kw)
    nudged = list(raw)
    nudged[1] = raw[1] * (1.0 + 1e-15)
    again = jax_solve(nudged, nu, **kw)
    assert max(rel_gap(getattr(again, f), getattr(want, f))
               for f in ("z", "lam", "s")) < 1e-10
    got = tqp.solve_qp(torch_qp(raw), nu=nu, **kw)
    assert torch.isfinite(got.z).all()
    for name in ("z", "lam", "s"):
        assert_close(getattr(got, name)[0], getattr(want, name))
    for name in ("comp", "eq_res"):
        assert_close(getattr(got, name)[0], getattr(want, name), atol=1e-15)
    mask = raw[7] > 0
    vals = np.einsum("tmz,tz->tm", raw[5], got.z[0].numpy()) + raw[6]
    assert vals[mask].min() > -1e-6  # feasible
    active = (vals < 1e-6) & mask
    assert active.any() == (tighten > 0)


def objective(raw, z):
    H, g = raw[0], raw[1]
    return float(0.5 * np.einsum("ti,tij,tj->", z, H, z)
                 + np.einsum("ti,ti->", g, z))


@pytest.mark.parametrize("seed,nu,tighten", [(2, 2, 0.5), (9, 3, 0.3)],
                         ids=["nu2-unstable", "nu3-unstable"])
def test_solve_qp_quality_where_jax_is_unstable(seed, nu, tighten):
    raw = random_qp(seed, nu=nu, tighten=tighten)
    H, g, A, B, c, D, e, mask, r0 = raw
    kw = dict(n_iters=30, mu_min=1e-9)
    want = jax_solve(raw, nu, **kw)
    nudged = list(raw)
    nudged[1] = g * (1.0 + 1e-15)
    again = jax_solve(nudged, nu, **kw)
    assert max(rel_gap(getattr(again, f), getattr(want, f))
               for f in ("z", "lam", "s")) > 1e-5  # JAX's own solve moves
    got = tqp.solve_qp(torch_qp(raw), nu=nu, **kw)
    z = got.z[0].numpy()
    assert np.isfinite(z).all()
    vals = np.einsum("tmz,tz->tm", D, z) + e
    assert vals[mask > 0].min() > -1e-6  # feasible
    dyn = (np.einsum("tij,tj->ti", A, z[:-1, nu:])
           + np.einsum("tij,tj->ti", B, z[:-1, :nu]) + c - z[1:, nu:])
    eq = max(np.abs(dyn).max(), np.abs(r0 - z[0, nu:]).max())
    assert eq < 1e-12
    assert float(got.eq_res[0]) < 1e-12
    assert float(got.comp[0]) <= 2.0 * float(want.comp)
    np.testing.assert_allclose(objective(raw, z),
                               objective(raw, np.asarray(want.z)), rtol=1e-7)


def test_converged_solve_freezes():
    """A converged solve hits the freeze: from there on every step is zero,
    so 60 iterations return exactly what 40 return, and both match JAX."""
    raw = random_qp(29, tighten=0.2)
    kw = dict(mu_min=1e-9)
    got40 = tqp.solve_qp(torch_qp(raw), nu=2, n_iters=40, **kw)
    got60 = tqp.solve_qp(torch_qp(raw), nu=2, n_iters=60, **kw)
    for name in ("z", "lam", "s"):
        assert torch.equal(getattr(got40, name), getattr(got60, name))
    want = jax_solve(raw, 2, n_iters=40, **kw)
    for name in ("z", "lam", "s"):
        assert_close(getattr(got40, name)[0], getattr(want, name))
    assert float(got40.comp[0]) < 1e-9


@pytest.mark.parametrize("nu", [2, 4])
def test_riccati_factor_outputs_match_jax(nu):
    """Each of the four outputs, stage by stage (P_nexts[k] is the value
    Hessian entering stage k+1), and the vector solve."""
    H, g, A, B, c, _, _, _, r0 = random_qp(4, T=7, nu=nu)
    want = jqp.riccati_factor(jnp.asarray(H), jnp.asarray(A),
                              jnp.asarray(B), nu)
    t = [torch.as_tensor(x)[None] for x in (H, g, A, B, c, r0)]
    got = tqp.riccati_factor(t[0], t[2], t[3], nu)
    for name, a, b in zip(("K", "L", "Qux", "P_next"), got, want):
        assert a.shape[1:] == b.shape, name
        assert_close(a[0], b, rtol=1e-12, atol=1e-14)
    # P_nexts[-1] is the terminal value Hessian H_xx[T-1]
    np.testing.assert_array_equal(got[3][0, -1].numpy(), H[-1, nu:, nu:])
    z_want = jqp.riccati_solve(*map(jnp.asarray, (H, g, A, B, c, r0)), nu)
    z_got = tqp.riccati_solve(*t, nu)
    assert_close(z_got[0], z_want, rtol=1e-12, atol=1e-14)


def test_batch_problems_are_independent():
    """Problem i alone and beside a NaN-poisoned problem: the same result,
    bit for bit; the poisoned one stays its own (z finite: its best iterate
    is the start, every later merit is NaN)."""
    a = random_qp(29, tighten=0.2)
    b = random_qp(13, tighten=0.3)
    poisoned = list(random_qp(23))
    poisoned[0] = poisoned[0].copy()
    poisoned[0][2, 0, 0] = np.nan
    kw = dict(nu=2, n_iters=25, mu_min=1e-9)
    alone = [tqp.solve_qp(torch_qp(x), **kw) for x in (a, b)]
    batch = tqp.solve_qp(torch_qp(a, poisoned, b), **kw)
    for i, one in zip((0, 2), alone):
        for name in one._fields:
            assert torch.equal(getattr(batch, name)[i],
                               getattr(one, name)[0]), name
    assert torch.equal(batch.z[1], torch.zeros_like(batch.z[1]))
    assert torch.isfinite(batch.z).all()
