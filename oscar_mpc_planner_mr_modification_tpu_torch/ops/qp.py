"""Stagewise constrained-QP solver: Mehrotra predictor-corrector IPM + Riccati.

Counterpart of the JAX package's ``ops/qp.py``: the plain version of the
single-instance SQP solve (:func:`..ops.sqp.make_sqp_solver` and the
``"xla"`` fleet backend on the CPU; on a CUDA device the kernel S1,
``csrc/sqp_single.cuh::solve_qp_problem``, runs the same iteration). Each
QP

    min  sum_k 1/2 z_k^T H_k z_k + g_k^T z_k          z_k = (u_k, x_k)
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k
         dx_0 = r0
         D_k z_k + e_k >= 0

is solved by a fixed number of Mehrotra predictor-corrector iterations whose
Newton systems are factorized by a Riccati sweep over the horizon: one
factorization per iteration serves the affine predictor and the corrector
(see the JAX module's docstring for the derivation and sign conventions).
Kept from the JAX solver: the centred start, separate primal and dual
fraction-to-boundary steps, the convergence freeze with its stationarity
term, the NaN guard and the best-merit iterate.

Every function works over a **leading batch axis**: QP fields are
``(B, T, ...)`` and every reduction runs over one problem's axes, never over
the batch, so a batch of B problems gives what B separate solves give (the
batchless call is ``B = 1``). The code is plain PyTorch with no host
synchronization inside a solve: no ``.item()``, no Python branch on a tensor;
a failed Cholesky factor (n > 3) becomes NaN, as in JAX.

Masked rows (``row_mask`` = 0) are padding: held at s=1, lam=0 with no
contribution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPData(NamedTuple):
    """Stagewise QP batch. T = N+1 stages; stage N's u-block padded (H_uu = I,
    H_ux = 0, g_u = 0) and its rows masked. ``row_mask`` is (B, T, m) or a
    (T, m) mask shared by the batch."""

    H: torch.Tensor  # (B, T, nz, nz)
    g: torch.Tensor  # (B, T, nz)
    A: torch.Tensor  # (B, T-1, nx, nx)
    B: torch.Tensor  # (B, T-1, nx, nu)
    c: torch.Tensor  # (B, T-1, nx) dynamics residual (defect)
    D: torch.Tensor  # (B, T, m, nz)
    e: torch.Tensor  # (B, T, m)
    row_mask: torch.Tensor  # (B, T, m) or (T, m); 1.0 = active row
    r0: torch.Tensor  # (B, nx) initial-state residual


class QPSolution(NamedTuple):
    z: torch.Tensor  # (B, T, nz) primal step (du_k, dx_k)
    lam: torch.Tensor  # (B, T, m) inequality duals
    s: torch.Tensor  # (B, T, m) slacks
    mu_final: torch.Tensor  # (B,)
    comp: torch.Tensor  # (B,) final mean complementarity (masked)
    eq_res: torch.Tensor  # (B,) final max dynamics residual


# ---------------------------------------------------------------------------
# Small SPD solves: closed-form inverse for n <= 3, Cholesky above
# ---------------------------------------------------------------------------
def spd_factor(M):
    """An opaque factorization of the SPD matrices M (..., n, n) for
    :func:`spd_solve`: the explicit inverse (adjugate over determinant) for
    n <= 3, the Cholesky factor above, NaN where it fails."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - b * b
        nb = -b
        inv = torch.stack([d, nb, nb, a], dim=-1).unflatten(-1, (2, 2))
        return inv / det[..., None, None]
    if n == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e = M[..., 1, 1], M[..., 1, 2]
        f = M[..., 2, 2]
        A00 = d * f - e * e
        A01 = c * e - b * f
        A02 = b * e - c * d
        A11 = a * f - c * c
        A12 = b * c - a * e
        A22 = a * d - b * b
        det = a * A00 + b * A01 + c * A02
        inv = torch.stack([
            torch.stack([A00, A01, A02], dim=-1),
            torch.stack([A01, A11, A12], dim=-1),
            torch.stack([A02, A12, A22], dim=-1),
        ], dim=-2)
        return inv / det[..., None, None]
    # cholesky_ex reports failure in ``info`` instead of raising (which would
    # read the flag back to the host): mark failed factors NaN.
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def spd_solve(fact, rhs):
    """Solve M x = rhs from :func:`spd_factor`'s output; rhs (..., n) or
    (..., n, k)."""
    n = fact.shape[-1]
    vec = rhs.dim() == fact.dim() - 1
    if n <= 3:
        if vec:
            return torch.einsum("...ij,...j->...i", fact, rhs)
        return fact @ rhs
    if vec:
        return torch.cholesky_solve(rhs[..., None], fact)[..., 0]
    return torch.cholesky_solve(rhs, fact)


# ---------------------------------------------------------------------------
# Riccati factorization + vector solves
#
# Each stage is a few batched small-matrix products, each product fused with
# the addition that follows it (baddbmm): on a CUDA device every op is a
# launch, and the sweeps are sequential over the stages.
# ---------------------------------------------------------------------------
def _t(M):
    return M.transpose(-1, -2)


def riccati_factor(H, A, B, nu: int):
    """Backward matrix sweep over H (B, T, nz, nz), A (B, T-1, nx, nx),
    B (B, T-1, nx, nu). Returns per stage k = 0..T-2 ``(Ks, Ls, Quxs,
    P_nexts)``: the feedback K, the factor of Quu, Qux and the value Hessian
    entering stage k+1 (the sweep's carry before stage k's update)."""
    AB = torch.cat([B, A], dim=-1)  # z's column order (u, x)
    P = H[:, -1, nu:, nu:]
    Ks, Ls, Quxs, P_nexts = [], [], [], []
    for k in range(A.shape[1] - 1, -1, -1):
        AB_k = AB[:, k]
        # [[Quu, Qux], [Qux^T, Qxx]] = H_k + [B A]^T P [B A]
        Q = torch.baddbmm(H[:, k], _t(AB_k), P @ AB_k)
        Qux = Q[:, :nu, nu:]
        L = spd_factor(Q[:, :nu, :nu])
        K = -spd_solve(L, Qux)
        P_new = torch.baddbmm(Q[:, nu:, nu:], _t(Qux), K)
        P_new = 0.5 * (P_new + _t(P_new))
        Ks.append(K)
        Ls.append(L)
        Quxs.append(Qux)
        P_nexts.append(P)
        P = P_new
    return tuple(torch.stack(x[::-1], dim=1) for x in (Ks, Ls, Quxs, P_nexts))


def riccati_solve_vec(fact, g, A, B, c, r0, nu: int):
    """Vector sweep for the gradient g (B, T, nz) and residuals c
    (B, T-1, nx), r0 (B, nx): returns z (B, T, nz)."""
    Ks, Ls, Quxs, P_nexts = fact
    AB = torch.cat([B, A], dim=-1)
    QuxT = _t(Quxs)
    # kff = -Quu^-1 qu: with the explicit inverse, one product by -L
    negL = -Ls if Ls.shape[-1] <= 3 else None
    g, c = g[..., None], c[..., None]  # column vectors
    n_st = A.shape[1]
    p = g[:, -1, nu:]
    kffs = [None] * n_st
    for k in range(n_st - 1, -1, -1):
        beta = torch.baddbmm(p, P_nexts[:, k], c[:, k])
        q = torch.baddbmm(g[:, k], _t(AB[:, k]), beta)  # (qu, qx)
        kff = (negL[:, k] @ q[:, :nu] if negL is not None
               else -spd_solve(Ls[:, k], q[:, :nu]))
        p = torch.baddbmm(q[:, nu:], QuxT[:, k], kff)
        kffs[k] = kff

    dx = r0[..., None]
    zs = []
    for k in range(n_st):
        du = torch.baddbmm(kffs[k], Ks[:, k], dx)
        z_k = torch.cat([du, dx], dim=1)
        zs.append(z_k)
        dx = torch.baddbmm(c[:, k], AB[:, k], z_k)
    zs.append(torch.cat([dx.new_zeros((dx.shape[0], nu, 1)), dx], dim=1))
    return torch.stack(zs, dim=1)[..., 0]


def riccati_solve(H, g, A, B, c, r0, nu: int):
    """Equality-constrained LQR solve (factor + one vector pass)."""
    fact = riccati_factor(H, A, B, nu)
    return riccati_solve_vec(fact, g, A, B, c, r0, nu)


# ---------------------------------------------------------------------------
# Mehrotra predictor-corrector IPM
# ---------------------------------------------------------------------------
def _amax(x):
    """Max over one problem's axes (all but the batch axis)."""
    return torch.amax(x, dim=tuple(range(1, x.dim())))


def _sum(x):
    return torch.sum(x, dim=tuple(range(1, x.dim())))


def _any(x):
    return torch.any(x.flatten(1), dim=1)


def solve_qp(qp: QPData, nu: int, n_iters: int = 15, mu_min: float = 1e-9,
             tau: float = 0.995, reg: float = 0.0, w_max: float = 1e14,
             s_floor: float = 1e-12, mu0: float = 1e2,
             tol_freeze: float | None = None) -> QPSolution:
    """Solve the batch of QPs with ``n_iters`` interior-point iterations and
    return each problem's best-merit iterate."""
    if tol_freeze is None:
        tol_freeze = max(10.0 * mu_min, 1e-12)
    H, g, A, B, c, D, e, r0 = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                               qp.r0)
    dtype = H.dtype
    Bb, T, m, nz = D.shape
    mask = torch.as_tensor(qp.row_mask, dtype=dtype,
                           device=H.device).expand(Bb, T, m)
    on = mask > 0
    # Scalars enter as Python numbers or fills on the device: a tensor made
    # from a host value would be a copy that waits for the stream.

    # Centred start: s0 = max(e, sqrt(mu0)) keeps satisfied rows at zero
    # residual, lam0 = mu0 / s0 makes every row's complementarity mu0.
    v0 = H.new_full((), mu0).sqrt()
    s = torch.where(on, torch.maximum(e, v0), 1.0)
    lam = torch.where(on, mu0 / s, 0.0)
    z = H.new_zeros((Bb, T, nz))
    n_active = torch.clamp(_sum(mask), min=1.0)

    def col(x):
        return x[:, None, None]

    def ftb(v, dv):
        """Fraction-to-boundary max step for v + a dv >= 0 over active rows."""
        ratio = torch.where(dv < 0, -v / torch.clamp(dv, max=-1e-30), 1e30)
        ratio = torch.where(on, ratio, 1e30)
        return torch.amin(ratio, dim=(1, 2))

    best_z, best_s, best_lam = z, s, lam
    best_merit = H.new_full((Bb,), float("inf"))
    eye = torch.eye(nz, dtype=dtype, device=H.device) if reg else None
    for _ in range(n_iters):
        Dz_e = torch.einsum("btmz,btz->btm", D, z) + e
        r_ineq = Dz_e - s
        W = torch.clamp(mask * lam / s, max=w_max)
        Hbar = H + torch.einsum("btmi,btm,btmj->btij", D, W, D)
        if reg:
            Hbar = Hbar + reg * eye
        fact = riccati_factor(Hbar, A, B, nu)

        rd = _dyn_residual(qp, z, nu)
        r0_res = r0 - z[:, 0, nu:]
        Hz_g = torch.einsum("btij,btj->bti", H, z) + g

        def newton(rhs3):
            """rhs3: target for s*lam per row. Returns dz, ds, dlam."""
            w_vec = mask * (lam * r_ineq - rhs3) / s
            gbar = Hz_g + torch.einsum("btmz,btm->btz", D, w_vec)
            dz = riccati_solve_vec(fact, gbar, A, B, rd, r0_res, nu)
            ds = torch.einsum("btmz,btz->btm", D, dz) + r_ineq
            dlam = (rhs3 - s * lam) / s - (lam / s) * ds
            return dz, torch.where(on, ds, 0.0), torch.where(on, dlam, 0.0)

        comp = _sum(mask * s * lam) / n_active

        # Predictor (affine, mu = 0)
        dz_a, ds_a, dlam_a = newton(torch.zeros_like(s))
        alpha_aff = torch.clamp(torch.minimum(ftb(s, ds_a), ftb(lam, dlam_a)),
                                max=1.0)
        comp_aff = _sum(mask * (s + col(alpha_aff) * ds_a)
                        * (lam + col(alpha_aff) * dlam_a)) / n_active

        # Centring + corrector
        sigma = torch.clamp((comp_aff / torch.clamp(comp, min=1e-30)) ** 3,
                            1e-8, 1.0)
        mu = torch.clamp(sigma * comp, min=mu_min)
        rhs3 = col(mu) - ds_a * dlam_a
        dz, ds, dlam = newton(rhs3)

        alpha_p = torch.clamp(tau * ftb(s, ds), max=1.0)
        alpha_d = torch.clamp(tau * ftb(lam, dlam), max=1.0)

        # Convergence freeze: zero steps once complementarity, the primal
        # residuals and the stationarity proxy (the affine step's size) are
        # tight; also zero steps when the step is NaN.
        feas = _amax(torch.abs(mask * r_ineq))
        eqr = torch.maximum(_amax(torch.abs(rd)), _amax(torch.abs(r0_res)))
        stat = torch.maximum(
            _amax(torch.abs(dz_a)) / (1.0 + _amax(torch.abs(z))),
            _amax(torch.abs(mask * dlam_a)) / (1.0 + _amax(mask * lam)))
        done = ((comp < tol_freeze) & (feas < 100.0 * tol_freeze)
                & (eqr < 100.0 * tol_freeze) & (stat < 1e3 * tol_freeze))
        bad = (_any(torch.isnan(dz)) | _any(torch.isnan(dlam))
               | _any(torch.isnan(ds)))
        scale = (~(done | bad)).to(dtype)
        alpha_p = alpha_p * scale
        alpha_d = alpha_d * scale

        # Best-iterate tracking on the KKT merit of the pre-step iterate.
        merit = comp + feas + eqr + stat
        better = merit < best_merit
        bc = col(better)
        best_z = torch.where(bc, z, best_z)
        best_s = torch.where(bc, s, best_s)
        best_lam = torch.where(bc, lam, best_lam)
        best_merit = torch.where(better, merit, best_merit)

        z = z + col(alpha_p) * dz
        s = torch.where(on, torch.clamp(s + col(alpha_p) * ds, min=s_floor),
                        1.0)
        lam = torch.where(on, torch.clamp(lam + col(alpha_d) * dlam, min=0.0),
                          0.0)

    z, s, lam = best_z, best_s, best_lam
    comp = _sum(mask * s * lam) / n_active
    eq_res = torch.maximum(_amax(torch.abs(_dyn_residual(qp, z, nu))),
                           _amax(torch.abs(r0 - z[:, 0, nu:])))
    return QPSolution(z=z, lam=lam, s=s, mu_final=comp, comp=comp,
                      eq_res=eq_res)


def _dyn_residual(qp: QPData, z, nu: int):
    """rd_k = A dx_k + B du_k + c_k - dx_{k+1} for the current QP iterate."""
    du = z[:, :-1, :nu]
    dx = z[:, :-1, nu:]
    dx_next = z[:, 1:, nu:]
    return (torch.einsum("btij,btj->bti", qp.A, dx)
            + torch.einsum("btij,btj->bti", qp.B, du) + qp.c - dx_next)
