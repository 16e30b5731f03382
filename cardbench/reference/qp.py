"""Plain PyTorch interior-point solvers of the stagewise QP

    min  sum_k 1/2 z_k^T H_k z_k + g_k^T z_k          z_k = (u_k, x_k)
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 = r0,  D_k z_k + e_k >= 0

by Mehrotra predictor-corrector iterations with one Riccati factorization
per iteration, over a leading batch axis. Two variants, as the two
algorithms the planner runs:

- :func:`solve_lanes`: a fixed count of iterations with a freeze on
  complementarity and the primal residuals (no stationarity term) or on a
  NaN step, and the last iterate returned;
- :func:`solve_single`: a centred start, a freeze that also asks for a small
  affine step, and the best iterate by a KKT merit returned.

Every reduction runs over one problem's axes, never over the batch.
"""

from __future__ import annotations

import torch


def _t(M):
    return M.transpose(-1, -2)


def _spd_inv(M):
    """Closed-form inverse of the SPD matrices M (..., n, n), n <= 3."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a, b, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
        inv_det = 1.0 / (a * d - b * b)
        return torch.stack([torch.stack([d * inv_det, -b * inv_det], -1),
                            torch.stack([-b * inv_det, a * inv_det], -1)], -2)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    A00, A01, A02 = d * f - e * e, c * e - b * f, b * e - c * d
    A11, A12, A22 = a * f - c * c, b * c - a * e, a * d - b * b
    inv_det = 1.0 / (a * A00 + b * A01 + c * A02)
    return torch.stack([
        torch.stack([A00, A01, A02], -1), torch.stack([A01, A11, A12], -1),
        torch.stack([A02, A12, A22], -1)], -2) * inv_det[..., None, None]


def riccati_factor(H, A, B, nu):
    """Backward matrix sweep: per stage k < T-1 (K, Quu^-1, Qux, P_{k+1})."""
    T = H.shape[1]
    P = H[:, T - 1, nu:, nu:]
    out = [None] * (T - 1)
    for k in range(T - 2, -1, -1):
        A_k, B_k = A[:, k], B[:, k]
        PA, PB = P @ A_k, P @ B_k
        Quu = H[:, k, :nu, :nu] + _t(B_k) @ PB
        Qux = H[:, k, :nu, nu:] + _t(B_k) @ PA
        Qxx = H[:, k, nu:, nu:] + _t(A_k) @ PA
        Linv = _spd_inv(Quu)
        K = -(Linv @ Qux)
        out[k] = (K, Linv, Qux, P)
        S = Qxx + _t(Qux) @ K
        P = 0.5 * (S + _t(S))
    return out


def riccati_solve(fact, g, A, B, c, r0, nu):
    """Vector sweep and forward rollout: z (Bt, T, nz)."""
    T = g.shape[1]
    p = g[:, T - 1, nu:]
    kff = [None] * (T - 1)
    for k in range(T - 2, -1, -1):
        K, Linv, Qux, P = fact[k]
        beta = p + (P @ c[:, k, :, None])[..., 0]
        qu = g[:, k, :nu] + (_t(B[:, k]) @ beta[..., None])[..., 0]
        qx = g[:, k, nu:] + (_t(A[:, k]) @ beta[..., None])[..., 0]
        kff[k] = -(Linv @ qu[..., None])[..., 0]
        p = qx + (_t(Qux) @ kff[k][..., None])[..., 0]
    rows, dx = [], r0
    for k in range(T - 1):
        du = (fact[k][0] @ dx[..., None])[..., 0] + kff[k]
        rows.append(torch.cat([du, dx], dim=-1))
        dx = ((A[:, k] @ dx[..., None])[..., 0]
              + (B[:, k] @ du[..., None])[..., 0] + c[:, k])
    rows.append(torch.cat([torch.zeros_like(du), dx], dim=-1))
    return torch.stack(rows, dim=1)


def _dyn_residual(z, A, B, c, nu):
    return ((A @ z[:, :-1, nu:, None])[..., 0]
            + (B @ z[:, :-1, :nu, None])[..., 0] + c - z[:, 1:, nu:])


def _amax(x):
    return torch.amax(x, dim=tuple(range(1, x.dim())))


def _sum(x):
    return torch.sum(x, dim=tuple(range(1, x.dim())))


def solve_lanes(H, g, A, B, c, D, e, r0, mask, *, nu, n_iters, mu_min,
                w_max, mu0=1e2, tau=0.995, s_floor=1e-10, tol_freeze=1e-5):
    """The first variant. D (Bt, T, m, nz) dense rows, e (Bt, T, m), mask
    (T, m); only rows active at some stage take part."""
    act = [r for r in range(mask.shape[1]) if mask[:, r].any()]
    G, e = D[:, :, act], e[:, :, act]
    mask = torch.as_tensor(mask[:, act], dtype=g.dtype, device=g.device)
    n_act = max(float(mask.sum()), 1.0)
    on = mask > 0
    big = torch.tensor(3e38, dtype=g.dtype, device=g.device)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)

    def Dz(zv):
        return torch.einsum("btrz,btz->btr", G, zv)

    def ftb(v, dv):
        ratio = torch.where(dv < 0, -v / torch.clamp(dv, max=-1e-30), big)
        return torch.amin(torch.where(on, ratio, big), dim=(1, 2))

    v0 = torch.sqrt(torch.tensor(mu0, dtype=g.dtype, device=g.device))
    s = torch.where(on, torch.maximum(e, v0), one)
    lam = torch.where(on, mu0 / s, zero)
    z = torch.zeros_like(g)
    for _ in range(n_iters):
        rin = Dz(z) + e - s
        W = torch.clamp(mask * lam / s, max=w_max)
        Hbar = H + torch.einsum("btri,btr,btrj->btij", G, W, G)
        comp = torch.sum(mask * s * lam, dim=(1, 2)) / n_act
        feas = torch.amax(torch.abs(mask * rin), dim=(1, 2))
        fact = riccati_factor(Hbar, A, B, nu)
        rd = _dyn_residual(z, A, B, c, nu)
        r0_res = r0 - z[:, 0, nu:]
        Hz_g = g + (H @ z[..., None])[..., 0]

        def gbar_of(rhs3):
            return Hz_g + torch.einsum("btrz,btr->btz", G,
                                       mask * (lam * rin - rhs3) / s)

        def dlam_of(rhs3, ds):
            return torch.where(on, (rhs3 - s * lam) / s - (lam / s) * ds,
                               zero)

        dz_a = riccati_solve(fact, gbar_of(0.0), A, B, rd, r0_res, nu)
        ds_a = torch.where(on, Dz(dz_a) + rin, zero)
        dlam_a = dlam_of(0.0, ds_a)
        alpha = torch.clamp(torch.minimum(ftb(s, ds_a), ftb(lam, dlam_a)),
                            max=1.0)[:, None, None]
        comp_aff = torch.sum(mask * (s + alpha * ds_a) * (lam + alpha * dlam_a),
                             dim=(1, 2)) / n_act
        sigma = torch.clamp((comp_aff / torch.clamp(comp, min=1e-30)) ** 3,
                            1e-8, 1.0)
        mu = torch.clamp(sigma * comp, min=mu_min)[:, None, None]
        rhs3 = mu - ds_a * dlam_a
        dz = riccati_solve(fact, gbar_of(rhs3), A, B, rd, r0_res, nu)
        ds = torch.where(on, Dz(dz) + rin, zero)
        dlam = dlam_of(rhs3, ds)
        nan_acc = torch.sum(dz, dim=(1, 2)) + torch.sum(dlam, dim=(1, 2))
        alpha_p = torch.clamp(tau * ftb(s, ds), max=1.0)
        alpha_d = torch.clamp(tau * ftb(lam, dlam), max=1.0)
        eqr = torch.maximum(torch.amax(torch.abs(rd), dim=(1, 2)),
                            torch.amax(torch.abs(r0_res), dim=1))
        done = ((comp < tol_freeze) & (feas < 100.0 * tol_freeze)
                & (eqr < 100.0 * tol_freeze))
        scale = torch.where(done | torch.isnan(nan_acc), zero, one)
        alpha_p = (alpha_p * scale)[:, None, None]
        alpha_d = (alpha_d * scale)[:, None, None]
        z = z + alpha_p * dz
        s = torch.where(on, torch.clamp(s + alpha_p * ds, min=s_floor), one)
        lam = torch.where(on, torch.clamp(lam + alpha_d * dlam, min=0.0), zero)
    return z


def solve_single(H, g, A, B, c, D, e, r0, mask, *, nu, n_iters, mu_min,
                 w_max, tau=0.995, s_floor=1e-12, mu0=1e2):
    """The second variant; returns (z, comp) of the best iterate."""
    tol_freeze = max(10.0 * mu_min, 1e-12)
    Bb, T, m, nz = D.shape
    mask = torch.as_tensor(mask, dtype=g.dtype,
                           device=g.device).expand(Bb, T, m)
    on = mask > 0
    v0 = H.new_full((), mu0).sqrt()
    s = torch.where(on, torch.maximum(e, v0), 1.0)
    lam = torch.where(on, mu0 / s, 0.0)
    z = H.new_zeros((Bb, T, nz))
    n_active = torch.clamp(_sum(mask), min=1.0)

    def col(x):
        return x[:, None, None]

    def ftb(v, dv):
        ratio = torch.where(dv < 0, -v / torch.clamp(dv, max=-1e-30), 1e30)
        return torch.amin(torch.where(on, ratio, 1e30), dim=(1, 2))

    best_z, best_s, best_lam = z, s, lam
    best_merit = H.new_full((Bb,), float("inf"))
    for _ in range(n_iters):
        r_ineq = torch.einsum("btmz,btz->btm", D, z) + e - s
        W = torch.clamp(mask * lam / s, max=w_max)
        Hbar = H + torch.einsum("btmi,btm,btmj->btij", D, W, D)
        fact = riccati_factor(Hbar, A, B, nu)
        rd = _dyn_residual(z, A, B, c, nu)
        r0_res = r0 - z[:, 0, nu:]
        Hz_g = torch.einsum("btij,btj->bti", H, z) + g

        def newton(rhs3):
            w_vec = mask * (lam * r_ineq - rhs3) / s
            gbar = Hz_g + torch.einsum("btmz,btm->btz", D, w_vec)
            dz = riccati_solve(fact, gbar, A, B, rd, r0_res, nu)
            ds = torch.einsum("btmz,btz->btm", D, dz) + r_ineq
            dlam = (rhs3 - s * lam) / s - (lam / s) * ds
            return dz, torch.where(on, ds, 0.0), torch.where(on, dlam, 0.0)

        comp = _sum(mask * s * lam) / n_active
        dz_a, ds_a, dlam_a = newton(torch.zeros_like(s))
        alpha_aff = torch.clamp(torch.minimum(ftb(s, ds_a), ftb(lam, dlam_a)),
                                max=1.0)
        comp_aff = _sum(mask * (s + col(alpha_aff) * ds_a)
                        * (lam + col(alpha_aff) * dlam_a)) / n_active
        sigma = torch.clamp((comp_aff / torch.clamp(comp, min=1e-30)) ** 3,
                            1e-8, 1.0)
        mu = torch.clamp(sigma * comp, min=mu_min)
        rhs3 = col(mu) - ds_a * dlam_a
        dz, ds, dlam = newton(rhs3)
        alpha_p = torch.clamp(tau * ftb(s, ds), max=1.0)
        alpha_d = torch.clamp(tau * ftb(lam, dlam), max=1.0)
        feas = _amax(torch.abs(mask * r_ineq))
        eqr = torch.maximum(_amax(torch.abs(rd)), _amax(torch.abs(r0_res)))
        stat = torch.maximum(
            _amax(torch.abs(dz_a)) / (1.0 + _amax(torch.abs(z))),
            _amax(torch.abs(mask * dlam_a)) / (1.0 + _amax(mask * lam)))
        done = ((comp < tol_freeze) & (feas < 100.0 * tol_freeze)
                & (eqr < 100.0 * tol_freeze) & (stat < 1e3 * tol_freeze))
        bad = (torch.isnan(dz).flatten(1).any(1)
               | torch.isnan(dlam).flatten(1).any(1)
               | torch.isnan(ds).flatten(1).any(1))
        scale = (~(done | bad)).to(g.dtype)
        alpha_p, alpha_d = alpha_p * scale, alpha_d * scale
        merit = comp + feas + eqr + stat
        better = merit < best_merit
        best_z = torch.where(col(better), z, best_z)
        best_s = torch.where(col(better), s, best_s)
        best_lam = torch.where(col(better), lam, best_lam)
        best_merit = torch.where(better, merit, best_merit)
        z = z + col(alpha_p) * dz
        s = torch.where(on, torch.clamp(s + col(alpha_p) * ds, min=s_floor),
                        1.0)
        lam = torch.where(on, torch.clamp(lam + col(alpha_d) * dlam, min=0.0),
                          0.0)
    comp = _sum(mask * best_s * best_lam) / n_active
    return best_z, comp


def f32_constants(mu_min, w_max, reg_eps):
    """The interior-point constants of a single-precision solve: the f64
    ones lie beyond f32's resolution."""
    return max(mu_min, 1e-6), min(w_max, 1e6), max(reg_eps, 1e-5)

