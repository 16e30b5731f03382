"""SQP-RTI engine (torch): linearize with ``torch.func``, solve the QP batch
with one launch of the interior-point kernel per SQP iteration.

Counterpart of the JAX package's ``ops/sqp.py``. ``backend="pallas"`` is the
per-iteration kernel path. Per iteration:
- cost gradient and Hessian per stage (forward-over-reverse ``torch.func``,
  vmapped over problems and stages); the terminal stage uses the terminal
  cost on x only, its u-block padded with the identity;
- Hessian PSD-ization: ``"mirror"`` (eigenvalues mirrored to |lambda| and
  floored), ``"gershgorin"`` (diagonal shift from the Gershgorin bound),
  ``"levenberg"`` (a constant diagonal shift) or ``"none"``;
- dynamics Jacobians A, B and defects c_k = F(z_k) - x_{k+1};
- inequality rows from the OCP's finite-bound row spec: h rows at stages
  0..N-1, u-box rows at 0..N-1, x-box rows at 1..N-1, stage N free;
- the QP batch through :func:`.qp_cuda.solve_qp_batched`, then a full step
  that keeps the previous iterate where the step is NaN. With
  ``n_qp_iter_warm > 0`` the QPs go through
  :func:`.qp_cuda.solve_qp_batched_duals` instead: iteration 0 cold with
  ``n_qp_iter`` iterations, every later one warm-started from the previous
  QPs' multipliers with ``n_qp_iter_warm``.

Success iff the final equality residual (dynamics defects and the initial
condition) is <= ``res_eq_tol`` and everything is finite.

``backend="fused"`` hands the whole solve to :mod:`.sqp_fused` (one kernel
launch per fleet solve, linearization included). ``backend="lanes"`` keeps
the batch on the trailing axis: per SQP iteration one launch of the fused
kernel's linearization (:mod:`.linearize`) and one of the QP kernel on its
output buffer. ``backend="xla"`` (the JAX package's name for its reference
path) solves the QPs with :func:`.qp.solve_qp`, the plain PyTorch
interior-point solver, as :func:`make_sqp_solver` does for one problem.

For runtime ticks, :func:`make_buffered_packed_solve` wraps a batched solve
into one upload, one solve and one readback (:func:`pack_results`,
:func:`unpack_results`, :func:`fetch_results`).
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from . import qp_cuda
from . import qp as qp_ip


class SQPConfig(NamedTuple):
    n_sqp: int = 10
    n_qp_iter: int = 15
    mu_min: float = 1e-9
    reg_eps: float = 1e-6
    w_max: float = 1e14
    regularization: str = "mirror"  # "mirror" | "gershgorin" | "levenberg" | "none"
    levenberg: float = 1e-3  # diagonal shift of "levenberg"
    res_eq_tol: float = 1e-2  # failure threshold on the equality residual
    merit_eq_weight: float = 1e3  # infeasibility penalty in best-iterate merit
    # Dual warm starts (backend="pallas"): iteration 0 solves its QPs cold
    # with n_qp_iter IP iterations, iterations 1..n_sqp-1 start from the
    # previous QPs' multipliers with n_qp_iter_warm. 0 disables.
    n_qp_iter_warm: int = 0
    # True: keep the best-merit iterate across SQP iterations; False: return
    # the last iterate and skip the per-iteration merit evaluation.
    track_best: bool = True
    # Inexact-SQP schedule ((n_sqp_a, n_qp_a), (n_sqp_b, n_qp_b), ...),
    # overriding (n_sqp, n_qp_iter) when non-empty.
    qp_iter_schedule: tuple = ()


class SQPResult(NamedTuple):
    z: torch.Tensor  # (B, N+1, nvar) primal trajectory (u_k, x_k); u_N is padding
    cost: torch.Tensor  # (B,) objective at the returned iterate
    eq_res: torch.Tensor  # (B,) max dynamics / initial-condition defect
    qp_comp: torch.Tensor  # (B,) last QP complementarity (0 on the fleet paths)
    success: torch.Tensor  # (B,) bool
    exit_code: torch.Tensor  # (B,) 1 = success, 0 = failure


def pack_results(res: SQPResult) -> torch.Tensor:
    """Every SQPResult field of a batch in ONE (B, T*nz + 5) tensor of z's
    dtype, on z's device: z flattened, then cost, eq_res, qp_comp,
    exit_code and success, so that the host reads a batch in one copy."""
    B = res.z.shape[0]
    flat = res.z.reshape(B, -1)
    extra = torch.stack([x.to(flat.dtype) for x in (
        res.cost, res.eq_res, res.qp_comp, res.exit_code, res.success)],
        dim=1)
    return torch.cat([flat, extra], dim=1)


def unpack_results(packed: np.ndarray, T: int, nz: int) -> SQPResult:
    """Host-side inverse of :func:`pack_results`: an SQPResult of numpy
    fields (z (B, T, nz) float, cost / eq_res / qp_comp (B,) float,
    exit_code (B,) int, success (B,) bool)."""
    B = packed.shape[0]
    n = T * nz
    return SQPResult(
        z=packed[:, :n].astype(float).reshape(B, T, nz),
        cost=packed[:, n].astype(float).copy(),
        eq_res=packed[:, n + 1].astype(float).copy(),
        qp_comp=packed[:, n + 2].astype(float).copy(),
        success=packed[:, n + 4] > 0.5,
        exit_code=np.rint(packed[:, n + 3]).astype(int))


def fetch_results(res: SQPResult) -> SQPResult:
    """A batch result on the host in one device-to-host copy, as numpy
    fields (:func:`unpack_results`)."""
    B, T, nz = res.z.shape
    return unpack_results(pack_results(res).cpu().numpy(), T, nz)


def fetch_result_single(res: SQPResult) -> SQPResult:
    """:func:`fetch_results` for a batchless result (z (T, nz), 0-d fields):
    one device-to-host copy; z a numpy array, the rest Python scalars."""
    batched = fetch_results(SQPResult(*(x[None] for x in res)))
    return SQPResult(
        z=batched.z[0], cost=float(batched.cost[0]),
        eq_res=float(batched.eq_res[0]), qp_comp=float(batched.qp_comp[0]),
        success=bool(batched.success[0]), exit_code=int(batched.exit_code[0]))


def make_buffered_packed_solve(batched_solve, P, N, npar, nx, nz, dtype,
                               device="cuda"):
    """A batched solve for runtime ticks: one upload, one solve, one readback.

    ``batched_solve(params (P, N, npar), xinit (nx,), warm (P, N+1, nz))``
    is any solve that takes tensors on ``device`` and returns an SQPResult.
    Returns ``solve(params, xinit, warm) -> packed`` (a (P, (N+1)*nz + 5)
    numpy array, decoded by :func:`unpack_results`) with the halves
    ``solve.dispatch`` and ``solve.fetch``:

    - ``dispatch`` encodes params, xinit and warm into one host buffer in the
      solve dtype (pinned when ``device`` is a CUDA device), copies it to the
      device with one ``non_blocking`` copy, runs the solve, packs the result
      (:func:`pack_results`) and copies it into a pinned host buffer with one
      ``non_blocking`` copy, records an event and returns. Nothing in it
      waits for the device, so the host may do the next tick's work while
      the solve runs;
    - ``fetch(handle)`` waits on that event and returns a copy of the packed
      result.

    The two host buffers are reused from solve to solve. That is safe
    because exactly one solve is in flight: ``dispatch`` raises while one is
    pending, and ``fetch`` returns only after the event, which the stream
    orders after the readback, which it orders after the upload; so when the
    next ``dispatch`` rewrites the input buffer the last upload from it has
    finished, and the output buffer is copied out before it is reused. On
    the CPU the same code runs without pinning, and the copies complete at
    once."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    T = N + 1
    n_par, n_warm = P * N * npar, P * T * nz
    host_in = torch.empty(n_par + nx + n_warm, dtype=dtype, pin_memory=cuda)
    host_out = torch.empty((P, T * nz + 5), dtype=dtype, pin_memory=cuda)
    dev_in = torch.empty(host_in.shape, dtype=dtype, device=device)
    staged = host_in.numpy()
    in_flight = []  # the pending handle; at most one

    def dispatch(params, xinit, warm):
        if in_flight:
            raise RuntimeError("a solve is already in flight; fetch it first")
        staged[:n_par] = np.asarray(params).reshape(-1)
        staged[n_par:n_par + nx] = np.asarray(xinit).reshape(-1)
        staged[n_par + nx:] = np.asarray(warm).reshape(-1)
        dev_in.copy_(host_in, non_blocking=True)
        res = batched_solve(dev_in[:n_par].view(P, N, npar),
                            dev_in[n_par:n_par + nx],
                            dev_in[n_par + nx:].view(P, T, nz))
        host_out.copy_(pack_results(res), non_blocking=True)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        in_flight.append(done)
        return done

    def fetch(handle):
        if not in_flight or in_flight[0] is not handle:
            raise RuntimeError("fetch of a handle that is not in flight")
        if handle is not None:
            handle.synchronize()
        in_flight.clear()
        return host_out.numpy().copy()

    def solve(params, xinit, warm):
        return fetch(dispatch(params, xinit, warm))

    solve.dispatch, solve.fetch = dispatch, fetch
    return solve


class QPData(NamedTuple):
    """Stagewise QP batch: H (B,T,nz,nz), g (B,T,nz), A (B,T-1,nx,nx),
    B (B,T-1,nx,nu), c (B,T-1,nx), D (B,T,m,nz), e (B,T,m), r0 (B,nx)."""

    H: torch.Tensor
    g: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    D: torch.Tensor
    e: torch.Tensor
    r0: torch.Tensor


def _mirror_regularize(H, eps):
    """Project the symmetric H to V |diag| V^T with eigenvalue floor eps.

    A matrix with a non-finite entry comes out NaN, as JAX's ``eigh`` gives
    it, instead of making ``torch.linalg.eigh`` raise: it is decomposed as
    the identity and then replaced. (``eigh`` still reads its convergence
    flags back to the host, so on a CUDA device every call waits for the
    device.)"""
    bad = ~torch.isfinite(H).all(dim=-1).all(dim=-1)[..., None, None]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    w, V = torch.linalg.eigh(torch.where(bad, eye, H))
    w = torch.clamp(torch.abs(w), min=eps)
    return torch.where(bad, float("nan"),
                       (V * w[..., None, :]) @ V.transpose(-1, -2))


def _f32_safe(config: SQPConfig, dtype) -> SQPConfig:
    """Clamp the interior-point constants to the f32 operating point when the
    solve runs in single precision: the f64 defaults (mu_min 1e-9, w_max 1e14)
    are below/above f32 resolution and break the QP iteration."""
    if dtype == torch.float64:
        return config
    return config._replace(
        mu_min=max(config.mu_min, 1e-6),
        w_max=min(config.w_max, 1e6),
        reg_eps=max(config.reg_eps, 1e-5),
    )


def _make_machinery(ocp, config: SQPConfig, dtype, device):
    """Batched linearization and merit functions for one OCP, dtype, device."""
    N, nu, nx, nvar = ocp.N, ocp.nu, ocp.nx, ocp.nvar
    row_spec = ocp.ineq_row_spec()
    stage_mask = ocp.stage_mask()
    # Box rows are tagged for the kernel's analytic path; generic rows carry
    # no column support, so every column counts (D is exactly 0 off support).
    row_meta = tuple(
        ("box", int(i), 1.0) if k == "zl"
        else ("box", int(i), -1.0) if k == "zu"
        else ("h", 0)
        for (k, i) in row_spec)

    def const(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    idx = {kind: [i for (k, i) in row_spec if k == kind]
           for kind in ("hl", "hu", "zl", "zu")}
    # the same row selections as index tensors on the device: a list index
    # would be copied from the host at every use, waiting for the device
    sel = {kind: torch.as_tensor(rows, dtype=torch.long, device=device)
           for kind, rows in idx.items()}
    lh, uh = const(ocp.lh[idx["hl"]]), const(ocp.uh[idx["hu"]])
    lbz, ubz = const(ocp.lbz[idx["zl"]]), const(ocp.ubz[idx["zu"]])
    unit = np.eye(nvar)
    unit_rows = const(np.concatenate(
        [unit[idx["zl"]], -unit[idx["zu"]]], axis=0).reshape(-1, nvar))
    eye_u = const(np.eye(nu))
    eye_z = const(np.eye(nvar))

    def stage_quad(z, p):
        """(grad, Hessian) of the stage cost at one stage."""
        def g_fn(zz):
            gz = grad(ocp.cost_stage)(zz, p)
            return gz, gz
        H, g = jacfwd(g_fn, has_aux=True)(z)
        return g, H

    def terminal_quad(x, p):
        def g_fn(xx):
            gx = grad(ocp.cost_terminal)(xx, p)
            return gx, gx
        H, g = jacfwd(g_fn, has_aux=True)(x)
        return g, H

    def dyn_z(z, p):
        return ocp.dynamics(z[nu:], z[:nu], p)

    def dyn_lin(z, p):
        """(F(z), dF/dz) at one stage."""
        def f_fn(zz):
            f = dyn_z(zz, p)
            return f, f
        J, f = jacfwd(f_fn, has_aux=True)(z)
        return f, J

    def ineq_lin(z, p):
        def h_fn(zz):
            h = ocp.ineq(zz, p)
            return h, h
        C, h = jacfwd(h_fn, has_aux=True)(z)
        return h, C

    stage_quad_v = vmap(vmap(stage_quad))
    terminal_quad_v = vmap(terminal_quad)
    dyn_lin_v = vmap(vmap(dyn_lin))
    ineq_lin_v = vmap(vmap(ineq_lin))
    dyn_v = vmap(vmap(dyn_z))
    cost_stage_v = vmap(vmap(ocp.cost_stage))
    cost_terminal_v = vmap(ocp.cost_terminal)

    def regularize(H):
        if config.regularization == "mirror":
            # Mirror the true stages; the terminal block is mirrored on x alone.
            H_body = _mirror_regularize(H[:, :-1], config.reg_eps)
            H_xx = _mirror_regularize(H[:, -1, nu:, nu:], config.reg_eps)
            H_last = torch.cat([
                torch.cat([H[:, -1, :nu, :nu], H[:, -1, :nu, nu:]], dim=-1),
                torch.cat([H[:, -1, nu:, :nu], H_xx], dim=-1)], dim=-2)
            return torch.cat([H_body, H_last[:, None]], dim=1)
        if config.regularization == "gershgorin":
            # Diagonal shift by the Gershgorin lower eigenvalue bound.
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            offdiag = torch.sum(torch.abs(H), dim=-1) - torch.abs(diag)
            bound = torch.amin(diag - offdiag, dim=-1)
            shift = torch.clamp(config.reg_eps - bound, min=0.0)
            return H + shift[..., None, None] * eye_z
        if config.regularization == "levenberg":
            return H + config.levenberg * eye_z
        if config.regularization == "none":
            return H
        raise ValueError(f"unknown regularization {config.regularization!r}")

    def build_qp(Z, P, xinit) -> QPData:
        """Linearize the OCP at Z for the batch: Z (B,T,nvar), P (B,T,npar),
        xinit (B,nx)."""
        Bb = Z.shape[0]
        g_s, H_s = stage_quad_v(Z[:, :-1], P[:, :-1])
        g_T, H_T = terminal_quad_v(Z[:, -1, nu:], P[:, -1])
        zeros_ux = torch.zeros((Bb, nu, nx), dtype=dtype, device=device)
        H_term = torch.cat([
            torch.cat([eye_u.expand(Bb, nu, nu), zeros_ux], dim=-1),
            torch.cat([zeros_ux.transpose(-1, -2), H_T], dim=-1)], dim=-2)
        g_term = torch.cat([torch.zeros((Bb, nu), dtype=dtype, device=device),
                            g_T], dim=-1)
        H = regularize(torch.cat([H_s, H_term[:, None]], dim=1))
        g = torch.cat([g_s, g_term[:, None]], dim=1)

        f, J = dyn_lin_v(Z[:, :-1], P[:, :-1])
        c = f - Z[:, 1:, nu:]

        h, C = ineq_lin_v(Z, P)
        D = torch.cat([C[:, :, sel["hl"]], -C[:, :, sel["hu"]],
                       unit_rows.expand(Bb, N + 1, -1, -1)], dim=2)
        e = torch.cat([h[:, :, sel["hl"]] - lh, uh - h[:, :, sel["hu"]],
                       Z[:, :, sel["zl"]] - lbz, ubz - Z[:, :, sel["zu"]]],
                      dim=2)
        return QPData(H=H, g=g, A=J[..., nu:], B=J[..., :nu], c=c, D=D, e=e,
                      r0=xinit - Z[:, 0, nu:])

    def merit_of(Z, P, xinit):
        """(merit, cost, eq_res, finite) per problem; the equality residual
        includes the initial-condition residual |xinit - x_0|."""
        f = dyn_v(Z[:, :-1], P[:, :-1])
        eq_res = torch.maximum(
            torch.amax(torch.abs(f - Z[:, 1:, nu:]), dim=(1, 2)),
            torch.amax(torch.abs(xinit - Z[:, 0, nu:]), dim=1))
        cost = (torch.sum(cost_stage_v(Z[:, :-1], P[:, :-1]), dim=1)
                + cost_terminal_v(Z[:, -1, nu:], P[:, -1]))
        finite = torch.isfinite(cost) & torch.all(torch.isfinite(Z), dim=(1, 2))
        merit = torch.where(finite, cost + config.merit_eq_weight * eq_res,
                            torch.full_like(cost, float("inf")))
        return merit, cost, eq_res, finite

    return types.SimpleNamespace(
        build_qp=build_qp, merit_of=merit_of, stage_mask=stage_mask,
        row_meta=row_meta, nu=nu, nvar=nvar, N=N)


def _phases_of(config: SQPConfig):
    """((n_sqp, n_qp_iter), ...): the inexact-SQP schedule, defaulting to one
    uniform phase."""
    return (tuple((int(n), int(q)) for n, q in config.qp_iter_schedule)
            or ((config.n_sqp, config.n_qp_iter),))


def scale_iterations(config: SQPConfig, n: int) -> SQPConfig:
    """Config limited to ``n`` total SQP iterations. Scheduled configs drop
    iterations from the front (loose) phases first."""
    if not config.qp_iter_schedule:
        return config._replace(n_sqp=n)
    phases = list(_phases_of(config))
    drop = sum(p[0] for p in phases) - n
    out = []
    for n_p, q_p in phases:
        d = min(max(drop, 0), n_p)
        drop -= d
        if n_p - d > 0:
            out.append((n_p - d, q_p))
    if not out:
        out = [(max(n, 1), phases[-1][1])]
    return config._replace(n_sqp=n, qp_iter_schedule=tuple(out))


def fleet_result(z, cost, eq_res, finite, config: SQPConfig) -> SQPResult:
    """SQPResult of a fleet solve from its final iterate's merit terms."""
    success = (eq_res <= config.res_eq_tol) & finite
    return SQPResult(z=z, cost=cost, eq_res=eq_res,
                     qp_comp=torch.zeros_like(cost), success=success,
                     exit_code=success.to(torch.int32))


def _make_reference_solver(ocp, config: SQPConfig, dtype, device):
    """The single-instance SQP of the JAX package's ``make_sqp_solver`` over a
    leading batch axis: ``solve(all_params (B, N, npar), xinit (B, nx),
    z_init (B, N+1, nvar)) -> SQPResult``, every QP through
    :func:`.qp.solve_qp`. Per problem, as JAX's vmap of it: one SQP loop per
    schedule phase, a full step kept back where it is NaN, the best-merit
    iterate (merit with the initial-condition residual) with ``track_best``,
    success from the final equality residual, and ``qp_comp`` the last QP's
    complementarity. Plain PyTorch on ``device``."""
    device = torch.device(device)
    config = _f32_safe(config, dtype)
    mach = _make_machinery(ocp, config, dtype, device)
    nu = mach.nu
    row_mask = torch.as_tensor(mach.stage_mask, dtype=dtype, device=device)

    def iteration(Z, best_Z, best_merit, P, xinit, n_iters):
        qp = mach.build_qp(Z, P, xinit)
        sol = qp_ip.solve_qp(
            qp_ip.QPData(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, row_mask,
                         qp.r0),
            nu=nu, n_iters=n_iters, mu_min=config.mu_min, w_max=config.w_max)
        Z_new = Z + sol.z
        # A NaN step (failed QP) keeps the previous iterate.
        bad = torch.any(torch.isnan(Z_new), dim=(1, 2), keepdim=True)
        Z_new = torch.where(bad, Z, Z_new)
        if not config.track_best:
            return Z_new, Z_new, best_merit, sol.comp
        merit = mach.merit_of(Z_new, P, xinit)[0]
        better = merit < best_merit
        return (Z_new, torch.where(better[:, None, None], Z_new, best_Z),
                torch.where(better, merit, best_merit), sol.comp)

    def solve(all_params, xinit, z_init) -> SQPResult:
        all_params = torch.as_tensor(all_params, dtype=dtype, device=device)
        P = torch.cat([all_params, all_params[:, -1:]], dim=1)  # stage N reuses N-1
        Z = torch.as_tensor(z_init, dtype=dtype, device=device)
        xinit = torch.as_tensor(xinit, dtype=dtype, device=device)
        best_Z, comp = Z, None
        best_merit = (mach.merit_of(Z, P, xinit)[0] if config.track_best
                      else None)
        for n_sqp, n_qp in _phases_of(config):
            for _ in range(n_sqp):
                Z, best_Z, best_merit, comp = iteration(
                    Z, best_Z, best_merit, P, xinit, n_qp)
        _, cost, eq_res, finite = mach.merit_of(best_Z, P, xinit)
        return fleet_result(best_Z, cost, eq_res, finite,
                            config)._replace(qp_comp=comp)

    solve.machinery = mach
    return solve


def make_sqp_solver(ocp, config: SQPConfig = SQPConfig(), *, dtype,
                    device="cuda"):
    """The single-instance SQP solve: ``solve(all_params (N, npar),
    xinit (nx,), z_init (N+1, nvar)) -> SQPResult`` with batchless fields
    on ``device`` (0-d cost, eq_res, qp_comp, success, exit_code), the JAX
    package's ``make_sqp_solver``. Inputs may be numpy arrays or tensors.
    It is plain PyTorch (:func:`.qp.solve_qp`): no kernel of this package.
    ``solve.batched`` solves a leading batch of problems, each as alone."""
    batched = _make_reference_solver(ocp, config, dtype, device)

    def solve(all_params, xinit, z_init) -> SQPResult:
        res = batched(*(torch.as_tensor(x, dtype=dtype, device=device)[None]
                        for x in (all_params, xinit, z_init)))
        return SQPResult(*(x[0] for x in res))

    solve.batched, solve.machinery = batched, batched.machinery
    return solve


def make_fleet_sqp_solver(ocp, config: SQPConfig = SQPConfig(), *, dtype,
                          device="cuda", backend: str = "pallas"):
    """Batched fleet solver.

    ``backend="pallas"``: every SQP iteration linearizes the whole batch with
    ``torch.func`` and solves its QPs with one
    :func:`.qp_cuda.solve_qp_batched` call (the kernel on a CUDA device, its
    plain version on the CPU), or with ``n_qp_iter_warm > 0`` one
    :func:`.qp_cuda.solve_qp_batched_duals` call, warm after the first.
    ``backend="fused"``: the whole solve in one launch of the fused kernel
    (:func:`.sqp_fused.make_fused_fleet_solver`). ``backend="lanes"``: per
    SQP iteration one launch of the fused kernel's linearization and one of
    the QP kernel on its output (:func:`_make_lane_fleet_solver`). The fused
    and lane backends raise for an OCP or regularization the fused kernel
    does not cover, and for ``n_qp_iter_warm > 0``. ``backend="xla"``: the
    reference path, every problem as :func:`make_sqp_solver` solves it
    (plain PyTorch, no kernel) but with ``qp_comp`` 0, as the JAX fleet
    backends return it; it too raises for ``n_qp_iter_warm > 0``.
    ``"pallas"`` raises ``ValueError`` at build on a CUDA device when the QP
    kernel is not compiled for the OCP's (nx, nu).

    Returns ``solve(all_params (B, N, npar), xinit (B, nx),
    z_init (B, N+1, nvar)) -> SQPResult``; inputs are moved to ``device`` and
    ``dtype``."""
    if backend == "fused":
        from .sqp_fused import make_fused_fleet_solver

        return make_fused_fleet_solver(ocp, config, dtype=dtype, device=device)
    if backend == "lanes":
        return _make_lane_fleet_solver(ocp, config, dtype=dtype, device=device)
    if backend == "xla":
        if config.n_qp_iter_warm > 0:
            raise ValueError("backend='xla' solves its QPs cold; "
                             "n_qp_iter_warm needs backend='pallas'")
        reference = _make_reference_solver(ocp, config, dtype, device)

        def solve(all_params, xinit, z_init) -> SQPResult:
            res = reference(all_params, xinit, z_init)
            return res._replace(qp_comp=torch.zeros_like(res.cost))

        solve.machinery = reference.machinery
        return solve
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}; expected 'fused', "
                         "'lanes', 'pallas' or 'xla'")
    dual_warm = config.n_qp_iter_warm > 0
    if dual_warm and config.qp_iter_schedule:
        raise ValueError(
            "qp_iter_schedule and n_qp_iter_warm are mutually exclusive "
            "(the warm path has its own per-iteration budget)")
    device = torch.device(device)
    if device.type == "cuda":
        # Before anything touches the device: the kernel would refuse these
        # sizes at its first launch.
        qp_cuda.check_instantiated(ocp.nx, ocp.nu)
    config = _f32_safe(config, dtype)
    mach = _make_machinery(ocp, config, dtype, device)
    kw = dict(nu=mach.nu, mu_min=config.mu_min, w_max=config.w_max,
              row_meta=mach.row_meta)

    def iteration(Z, best_Z, best_merit, P, xinit, n_iters, lam):
        qp = mach.build_qp(Z, P, xinit)
        args = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask,
                qp.r0)
        if dual_warm:
            dz, lam = qp_cuda.solve_qp_batched_duals(*args, lam0=lam,
                                                     n_iters=n_iters, **kw)
            # A failed QP's duals are useless: reseed the next warm start
            # with 1 (clipped to [mu_min, w_max] in the kernel).
            lam = torch.where(torch.isnan(lam), torch.ones_like(lam), lam)
        else:
            dz = qp_cuda.solve_qp_batched(*args, n_iters=n_iters, **kw)
        Z_new = Z + dz
        bad = torch.any(torch.isnan(Z_new), dim=(1, 2), keepdim=True)
        Z_new = torch.where(bad, Z, Z_new)
        if not config.track_best:
            return Z_new, Z_new, best_merit, lam
        merit, _, _, _ = mach.merit_of(Z_new, P, xinit)
        better = (merit < best_merit)[:, None, None]
        return (Z_new, torch.where(better, Z_new, best_Z),
                torch.minimum(merit, best_merit), lam)

    phases = (((1, config.n_qp_iter),
               (config.n_sqp - 1, config.n_qp_iter_warm)) if dual_warm
              else _phases_of(config))

    def solve(all_params, xinit, z_init) -> SQPResult:
        all_params = torch.as_tensor(all_params, dtype=dtype, device=device)
        P = torch.cat([all_params, all_params[:, -1:]], dim=1)  # stage N reuses N-1
        Z = torch.as_tensor(z_init, dtype=dtype, device=device)
        xinit = torch.as_tensor(xinit, dtype=dtype, device=device)
        best_Z, lam = Z, None
        best_merit = (mach.merit_of(Z, P, xinit)[0] if config.track_best
                      else None)
        for n_sqp, n_qp in phases:
            for _ in range(n_sqp):
                Z, best_Z, best_merit, lam = iteration(
                    Z, best_Z, best_merit, P, xinit, n_qp, lam)
        _, cost, eq_res, finite = mach.merit_of(best_Z, P, xinit)
        return fleet_result(best_Z, cost, eq_res, finite, config)

    solve.machinery = mach
    return solve


def _make_lane_fleet_solver(ocp, config: SQPConfig, *, dtype, device):
    """Fleet solver with the batch on the trailing axis from end to end.

    Per SQP iteration: one launch of the fused kernel's linearization
    (:func:`.linearize.make_lane_linearizer`'s ``fields``), which writes the
    QP in the QP kernel's field-major layout and the merit terms of the
    iterate, then one launch of the QP kernel that reads that buffer where it
    lies (:func:`.qp_cuda.solve_qp_fields`): no ``torch.func``, no copy, no
    transpose. Then the full step, kept back where it is NaN. The merit of
    each iterate comes with its linearization, so best-iterate tracking
    judges iterate k at iteration k (JAX judges it at the end of k-1: the
    same comparisons in the same order); one merit launch for the last
    iterate ends the solve. On the CPU the plain versions run. Raises at
    build time for what the fused kernel does not cover."""
    from .linearize import make_lane_linearizer

    if config.n_qp_iter_warm > 0:
        raise ValueError("backend='lanes' solves its QPs cold; "
                         "n_qp_iter_warm needs backend='pallas'")
    device = torch.device(device)
    config = _f32_safe(config, dtype)
    lin = make_lane_linearizer(ocp, config, dtype=dtype, device=device)
    mach = lin.machinery
    kw = dict(nu=mach.nu, mu_min=config.mu_min, w_max=config.w_max,
              row_meta=mach.row_meta)

    def solve(all_params, xinit, z_init) -> SQPResult:
        all_params = torch.as_tensor(all_params, dtype=dtype, device=device)
        P = torch.cat([all_params, all_params[:, -1:]], dim=1)
        P_cols = P.permute(2, 1, 0).contiguous()  # (npar, T, B)
        Z = torch.as_tensor(z_init, dtype=dtype,
                            device=device).permute(1, 2, 0).contiguous()
        x_cols = torch.as_tensor(xinit, dtype=dtype,
                                 device=device).t().contiguous()
        T, nz, B = Z.shape
        best = None  # (Z, merit, cost, eq_res) of the best iterate so far

        def track(Z, terms):
            nonlocal best
            if best is None:
                best = (Z, *terms)
                return
            better = terms[0] < best[1]
            best = (torch.where(better, Z, best[0]),
                    torch.minimum(terms[0], best[1]),
                    torch.where(better, terms[1], best[2]),
                    torch.where(better, terms[2], best[3]))

        for n_sqp, n_qp in _phases_of(config):
            for _ in range(n_sqp):
                fields, terms = lin.fields(P_cols, Z, x_cols)
                if config.track_best:
                    track(Z, terms)
                dz = qp_cuda.solve_qp_fields(fields, mach.stage_mask,
                                             n_iters=n_qp, **kw)
                Z_new = Z + dz.reshape(T, nz, B)
                bad = torch.any(torch.isnan(Z_new), dim=(0, 1))
                Z = torch.where(bad, Z, Z_new)
        last = lin.merit_terms(P_cols, Z, x_cols)
        if config.track_best:
            track(Z, last)
            Z, _, cost, eq_res = best
        else:
            _, cost, eq_res = last
        finite = torch.isfinite(cost) & torch.all(torch.isfinite(Z),
                                                  dim=(0, 1))
        return fleet_result(Z.permute(2, 0, 1).contiguous(), cost, eq_res,
                            finite, config)

    solve.machinery, solve.tables = mach, lin.tables
    return solve
