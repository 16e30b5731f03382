"""The plain reference SQP: linearize the OCP (:mod:`.ocp`) with
``torch.func`` at the iterate, make every stage Hessian positive definite
by mirroring its eigenvalues (V max(|w|, eps) V^T, ``torch.linalg.eigh``;
the terminal stage on its state block alone), solve the QP (:mod:`.qp`),
take the full step (kept back where it is NaN) and keep the iterate of
least merit (cost + weight * the largest dynamics or initial-state defect).
A problem succeeds where that defect is within ``res_eq_tol`` and every
number is finite.

``solve(ocp, sqp, params (B, N, npar), xinit (B, nx), z_init (B, N+1, nz),
variant, dtype)`` runs the whole solve; ``variant`` names the QP solver
("lanes" or "single") and the order in which the best iterate is judged,
as the planner's two paths do. ``merit_terms`` evaluates (cost, eq_res)
of given iterates."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from . import ocp as ocp_mod
from .qp import f32_constants, solve_lanes, solve_single


class Solution(NamedTuple):
    z: torch.Tensor  # (B, N+1, nz)
    cost: torch.Tensor  # (B,)
    eq_res: torch.Tensor  # (B,)
    success: torch.Tensor  # (B,) bool


def _machinery(ocp, dtype, device):
    nu = ocp_mod.NU
    spec = ocp_mod.row_spec(ocp)
    sel = {k: torch.as_tensor([i for (kk, i) in spec if kk == k],
                              dtype=torch.long, device=device)
           for k in ("hl", "hu", "zl", "zu")}

    def const(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    lh, uh = const(ocp.lh)[sel["hl"]], const(ocp.uh)[sel["hu"]]
    lbz, ubz = const(ocp_mod.LOWER)[sel["zl"]], const(ocp_mod.UPPER)[sel["zu"]]
    eye = np.eye(ocp_mod.NZ)
    unit = const(np.concatenate([eye[sel["zl"].cpu().numpy()],
                                 -eye[sel["zu"].cpu().numpy()]]))

    def quad(f):
        def g_and_h(z, p):
            def g_fn(zz):
                gz = grad(f)(zz, p)
                return gz, gz
            H, g = jacfwd(g_fn, has_aux=True)(z)
            return g, H
        return g_and_h

    def with_value(f):
        def fj(z, p):
            def f_fn(zz):
                v = f(zz, p)
                return v, v
            J, v = jacfwd(f_fn, has_aux=True)(z)
            return v, J
        return fj

    def dyn_z(z, p):
        return ocp.dynamics(z[nu:], z[:nu])

    stage_quad = vmap(vmap(quad(ocp.cost_stage)))
    terminal_quad = vmap(quad(ocp.cost_terminal))
    dyn_lin = vmap(vmap(with_value(dyn_z)))
    ineq_lin = vmap(vmap(with_value(ocp.ineq)))
    dyn_v = vmap(vmap(dyn_z))
    cost_stage_v = vmap(vmap(ocp.cost_stage))
    cost_terminal_v = vmap(ocp.cost_terminal)

    def build_qp(Z, P, xinit, reg_eps):
        B = Z.shape[0]
        # torch.func promotes some single-precision derivatives to double
        # (a Python float beside a 0-d tensor): every field is cast back
        g_s, H_s = (t.to(dtype) for t in stage_quad(Z[:, :-1], P[:, :-1]))
        g_T, H_T = (t.to(dtype) for t in terminal_quad(Z[:, -1, nu:],
                                                       P[:, -1]))
        H_T = _mirror(H_T, reg_eps)
        H_last = torch.zeros((B, ocp_mod.NZ, ocp_mod.NZ), dtype=dtype,
                             device=device)
        H_last[:, :nu, :nu] = torch.eye(nu, dtype=dtype, device=device)
        H_last[:, nu:, nu:] = H_T
        H = torch.cat([_mirror(H_s, reg_eps), H_last[:, None]], dim=1)
        g = torch.cat([g_s, torch.cat([torch.zeros((B, nu), dtype=dtype,
                                                   device=device), g_T],
                                      dim=-1)[:, None]], dim=1)
        f, J = (t.to(dtype) for t in dyn_lin(Z[:, :-1], P[:, :-1]))
        h, C = (t.to(dtype) for t in ineq_lin(Z, P))
        D = torch.cat([C[:, :, sel["hl"]], -C[:, :, sel["hu"]],
                       unit.expand(B, Z.shape[1], -1, -1)], dim=2)
        e = torch.cat([h[:, :, sel["hl"]] - lh, uh - h[:, :, sel["hu"]],
                       Z[:, :, sel["zl"]] - lbz, ubz - Z[:, :, sel["zu"]]],
                      dim=2)
        return (H, g, J[..., nu:], J[..., :nu], f - Z[:, 1:, nu:], D, e,
                xinit - Z[:, 0, nu:])

    def merit_terms(Z, P, xinit):
        f = dyn_v(Z[:, :-1], P[:, :-1])
        eq_res = torch.maximum(
            torch.amax(torch.abs(f - Z[:, 1:, nu:]), dim=(1, 2)),
            torch.amax(torch.abs(xinit - Z[:, 0, nu:]), dim=1))
        cost = (torch.sum(cost_stage_v(Z[:, :-1], P[:, :-1]), dim=1)
                + cost_terminal_v(Z[:, -1, nu:], P[:, -1]))
        return cost.to(dtype), eq_res.to(dtype)

    return build_qp, merit_terms


def _mirror(H, eps):
    """V max(|w|, eps) V^T of symmetric blocks; NaN where H is not finite."""
    bad = ~torch.isfinite(H).all(dim=-1).all(dim=-1)[..., None, None]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    w, V = torch.linalg.eigh(torch.where(bad, eye, H))
    w = torch.clamp(torch.abs(w), min=eps)
    return torch.where(bad, float("nan"), (V * w[..., None, :]) @ V.mT)


def merit_terms(ocp, params, xinit, Z, dtype=torch.float64, device="cpu"):
    """(cost, eq_res) at the iterates Z (B, N+1, nz)."""
    P = _stage_params(params, dtype, device)
    _, terms = _machinery(ocp, dtype, device)
    return terms(torch.as_tensor(Z, dtype=dtype, device=device), P,
                 torch.as_tensor(xinit, dtype=dtype, device=device))


def _stage_params(params, dtype, device):
    p = torch.as_tensor(np.asarray(params), dtype=dtype, device=device)
    return torch.cat([p, p[:, -1:]], dim=1)  # stage N reuses N-1


def solve(ocp, sqp: dict, params, xinit, z_init, variant: str,
          dtype=torch.float64, device="cpu") -> Solution:
    """The whole SQP solve of a batch of problems (see the module doc)."""
    mu_min, w_max, reg_eps = sqp["mu_min"], sqp["w_max"], sqp["reg_eps"]
    if dtype != torch.float64:
        mu_min, w_max, reg_eps = f32_constants(mu_min, w_max, reg_eps)
    build_qp, terms = _machinery(ocp, dtype, device)
    mask = ocp_mod.stage_mask(ocp)
    nu = ocp_mod.NU
    P = _stage_params(params, dtype, device)
    x0 = torch.as_tensor(np.asarray(xinit), dtype=dtype, device=device)
    Z = torch.as_tensor(np.asarray(z_init), dtype=dtype, device=device)
    weight = sqp["merit_eq_weight"]

    def merit(Z):
        cost, eq = terms(Z, P, x0)
        finite = torch.isfinite(cost) & torch.isfinite(Z).all(dim=(1, 2))
        return torch.where(finite, cost + weight * eq,
                           torch.full_like(cost, float("inf")))

    best_Z, best_m = Z, merit(Z)
    for _ in range(int(sqp["n_sqp"])):
        if variant == "lanes":
            # judged at the start of each iteration, as the lane path does
            m = merit(Z)
            better = (m < best_m)[:, None, None]
            best_Z, best_m = torch.where(better, Z, best_Z), torch.minimum(
                m, best_m)
        H, g, A, B, c, D, e, r0 = build_qp(Z, P, x0, reg_eps)
        kw = dict(nu=nu, n_iters=int(sqp["n_qp_iter"]), mu_min=mu_min,
                  w_max=w_max)
        if variant == "lanes":
            Hs = torch.triu(H) + torch.triu(H, diagonal=1).mT
            dz = solve_lanes(Hs, g, A, B, c, D, e, r0, mask, **kw)
        elif variant == "single":
            dz = solve_single(H, g, A, B, c, D, e, r0, mask, **kw)[0]
        else:
            raise ValueError(f"unknown variant {variant!r}")
        Z_new = Z + dz
        bad = torch.isnan(Z_new).any(dim=(1, 2), keepdim=True)
        Z = torch.where(bad, Z, Z_new)
        if variant == "single":
            m = merit(Z)
            better = (m < best_m)[:, None, None]
            best_Z, best_m = torch.where(better, Z, best_Z), torch.where(
                m < best_m, m, best_m)
    if variant == "lanes":
        m = merit(Z)
        better = (m < best_m)[:, None, None]
        best_Z = torch.where(better, Z, best_Z)
    cost, eq_res = terms(best_Z, P, x0)
    finite = torch.isfinite(cost) & torch.isfinite(best_Z).all(dim=(1, 2))
    return Solution(best_Z, cost, eq_res,
                    (eq_res <= sqp["res_eq_tol"]) & finite)
