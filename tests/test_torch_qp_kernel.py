"""The port's interior-point QP (plain PyTorch version of the Hopper kernel)
against the JAX package's Pallas kernel run in interpret mode.

Both run the same algorithm on the same f64 inputs, so only the order of sums
differs: the tolerance is atol 1e-8. The solver constants are the kernel's own
defaults (mu_min 1e-6, w_max 1e6, tol_freeze 1e-5), at which the per-problem
freeze engages within the iteration budget. The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops.qp_pallas import (  # noqa: E402
    solve_qp_batched as jax_kernel)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda  # noqa: E402

from test_qp import random_qp  # noqa: E402

KW = dict(nu=2)


def _with_box_rows(raw, seed, n_box):
    """Append n_box one-sided variable bounds (alternating sign, a partially
    masked pair) to a random_qp instance; z = 0 stays feasible."""
    H, g, A, B, c, D, e, mask, r0 = raw
    T, m_h, nz = D.shape
    rng = np.random.default_rng(seed)
    D2 = np.zeros((T, m_h + n_box, nz))
    e2 = np.ones((T, m_h + n_box))
    mask2 = np.ones((T, m_h + n_box))
    D2[:, :m_h], e2[:, :m_h], mask2[:, :m_h] = D, e, mask
    meta = [("h", 0)] * m_h
    for j in range(n_box):
        col, sign = j % nz, (1.0 if j % 2 == 0 else -1.0)
        D2[:, m_h + j, col] = sign
        e2[:, m_h + j] = rng.uniform(0.2, 1.0)
        meta.append(("box", col, sign))
    mask2[-1] = 0.0
    mask2[0, [m_h, m_h + 1]] = 0.0
    return (H, g, A, B, c, D2, e2, mask2, r0), tuple(meta)


def _solve_both(raws, row_meta, n_iters):
    batch = [np.stack([raw[i] for raw in raws]) for i in range(9)]
    mask = batch[7][0]
    z_jax = np.asarray(jax_kernel(
        *[jnp.asarray(x) for x in batch[:7]], mask, jnp.asarray(batch[8]),
        n_iters=n_iters, interpret=True, row_meta=row_meta, **KW))
    z_port = qp_cuda.solve_qp_batched(
        *[torch.as_tensor(x) for x in batch[:7]], mask,
        torch.as_tensor(batch[8]), n_iters=n_iters, row_meta=row_meta, **KW)
    assert z_port.dtype == torch.float64 and z_port.shape == z_jax.shape
    return z_jax, z_port.numpy()


def test_plain_matches_interpreted_kernel():
    """random_qp instances (T=4), two tightened so that z = 0 violates rows,
    with generic and box rows (a partially masked box pair)."""
    raws = []
    for seed, tighten in ((0, 0.0), (1, 0.0), (7, 0.5), (11, 0.8)):
        H, g, A, B, c, D, e, mask, r0 = random_qp(seed, T=4)[1]
        e = np.where(mask > 0, e - tighten, e)
        raw, meta = _with_box_rows((H, g, A, B, c, D, e, mask, r0), seed, 4)
        raws.append(raw)
    launches = qp_cuda.launches
    z_jax, z_port = _solve_both(raws, meta, n_iters=12)
    assert qp_cuda.launches == launches  # the CPU path launches no kernel
    assert np.isfinite(z_port).all()
    np.testing.assert_allclose(z_port, z_jax, rtol=0, atol=1e-8)


def test_plain_matches_kernel_without_active_rows():
    """Every row masked at every stage, and m == 0 (padded to one masked
    row): with no active row both solve the equality-constrained QP with one
    exact Riccati pass, so both port cases match the kernel's all-masked one."""
    H, g, A, B, c, D, e, mask, r0 = random_qp(3, T=4)[1]
    T, nz = g.shape
    z_jax, z_port = _solve_both(
        [(H, g, A, B, c, D, e, np.zeros_like(mask), r0)], None, 12)
    np.testing.assert_allclose(z_port, z_jax, rtol=0, atol=1e-8)
    z_m0 = qp_cuda.solve_qp_batched(
        *[torch.as_tensor(x)[None] for x in (H, g, A, B, c)],
        torch.zeros((1, T, 0, nz), dtype=torch.float64),
        torch.zeros((1, T, 0), dtype=torch.float64), np.zeros((T, 0)),
        torch.as_tensor(r0)[None], n_iters=12, **KW)
    np.testing.assert_allclose(z_m0.numpy(), z_jax, rtol=0, atol=1e-8)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    raw = [torch.as_tensor(x)[None] for x in random_qp(0)[1]]
    H, g, A, B, c, D, e, mask, r0 = raw
    with pytest.raises(ValueError, match="g must be"):
        qp_cuda.solve_qp_batched(H, g[:, :-1], A, B, c, D, e, mask[0], r0, nu=2)
    with pytest.raises(ValueError, match="expected torch.float64"):
        qp_cuda.solve_qp_batched(H, g.float(), A, B, c, D, e, mask[0], r0, nu=2)
    with pytest.raises(TypeError, match="float32 or float64"):
        qp_cuda.solve_qp_batched(*(x.half() for x in (H, g, A, B, c, D, e)),
                                 mask[0], r0.half(), nu=2)
    with pytest.raises(ValueError, match=r"row_mask must be \(T, m\)"):
        qp_cuda.solve_qp_batched(H, g, A, B, c, D, e, mask[0, :, :2], r0, nu=2)
    # nu = 4 (nx = 1): the closed-form SPD inverse covers nu <= 3 only
    Bt, T, nz = g.shape
    B4 = torch.zeros((Bt, T - 1, 1, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="nu <= 3"):
        qp_cuda.solve_qp_batched(H, g, A[..., :1, :1], B4, c[..., :1], D, e,
                                 mask[0], r0[..., :1], nu=4)


def test_spd_inverse_matches_linalg():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3):
        M = rng.normal(size=(5, n, n))
        M = torch.as_tensor(M @ np.swapaxes(M, -1, -2) + n * np.eye(n))
        np.testing.assert_allclose(qp_cuda._spd_inv(M).numpy(),
                                   torch.linalg.inv(M).numpy(), atol=1e-12)
    with pytest.raises(NotImplementedError):
        qp_cuda._spd_inv(torch.eye(4, dtype=torch.float64))


@pytest.mark.slow
def test_plain_matches_interpreted_kernel_bench_shape():
    """The fleet step's row structure and widths (nx=5, nu=2, 8 generic and
    14 box rows, m=22) at T=6. Interpret mode unrolls the kernel's stage
    loops, and at the bench's T=21 it takes more than 50 GB of host memory;
    T=21 itself is held against the plain version on the card by
    ``chip_smoke.py``."""
    raws = []
    for seed in (0, 5):
        H, g, A, B, c, D, e, mask, r0 = random_qp(seed, T=6, nx=5, nu=2,
                                                  m=8)[1]
        raw, meta = _with_box_rows((H, g, A, B, c, 0.5 * D, e, mask, r0),
                                   seed, 14)
        raws.append(raw)
    z_jax, z_port = _solve_both(raws, meta, n_iters=8)
    np.testing.assert_allclose(z_port, z_jax, rtol=0, atol=1e-8)
