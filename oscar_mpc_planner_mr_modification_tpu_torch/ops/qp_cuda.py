"""Batched stagewise interior-point QP: the Hopper kernel and its plain twin.

Counterpart of the JAX package's ``ops/qp_pallas.py``. Each problem is the
stagewise QP over T stages, ``z_k = (u_k, x_k)``:

    min  sum_k 1/2 z_k^T H_k z_k + g_k^T z_k
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 = r0,  D_k z_k + e_k >= 0

solved by a fixed count of Mehrotra predictor-corrector iterations with one
Riccati factorization per iteration, a per-problem freeze on convergence
(complementarity, inequality and equality residuals below tolerance, with no
stationarity term) or on a NaN step, and no best-iterate tracking.

Three entries, all on the kernel ``csrc/qp_ip.cu`` (built with nvcc for
``sm_90a`` at first use, loaded with ctypes, launched on the current
stream; one warp per problem, its state in shared memory) for CUDA tensors
and on :func:`ip_solve_reference` for CPU tensors; none falls back: a
kernel that fails to build or launch raises, and so does an (nx, nu) the
kernel is not compiled for (``INSTANTIATED``).

- :func:`solve_qp_batched`: batch-major tensors, cold start, z out.
- :func:`solve_qp_batched_duals`: the same, plus the final multipliers, and
  optionally a warm start from given ones (``lam0``).
- :func:`solve_qp_lanes` / :func:`solve_qp_fields`: the batch on the
  trailing axis (JAX's ``LaneQP`` layouts, or the kernel's own field-major
  buffers, which it reads with no copy), cold start, z out.

:func:`ip_solve_reference` is the plain PyTorch version of the iteration,
batched over the leading axis. :func:`host_solve_qp_fields` runs the
kernel's own per-problem code compiled for the host
(``csrc/tmpc_ocp_host.cpp``, 32 emulated lanes per problem), for the CPU
tests. ``launches``, ``duals_launches`` and
``lanes_launches`` count the kernel launches of the three entries;
``warm_launches`` counts the duals entry's launches with a warm start.

Row structure: ``row_meta`` tags each row ``("box", col, sign)`` for a one-hot
variable bound, or ``("h", slot)`` for a generic row. Generic rows are dense:
every column counts, which is exact because D is 0 off a row's support. The
kernel takes the row table and the (T, m) stage mask as small device tables;
it reads a generic row's D slot as dense over z, as ``row_meta`` builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

#: Kernel launches in this process, per entry (the plain version does not
#: count): cold z-only batch-major, duals/warm (of which warm-started), and
#: lane layout.
launches = 0
duals_launches = 0
warm_launches = 0
lanes_launches = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Kernel libraries: name -> CUDA source in ``csrc/``.
KERNELS = {"qp_ip": "qp_ip.cu", "sqp_fused": "sqp_fused.cu",
           "fma_roof": "fma_roof.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_MAX_NU = 3  # the plain version's closed-form SPD inverse
#: (nx, nu) pairs the kernels are compiled for (template instantiations of
#: ``csrc/qp_ip.cuh::with_dims``): the port's
#: ContouringSecondOrderUnicycleModel (5, 2), SecondOrderUnicycleModel
#: (4, 2), ContouringSecondOrderUnicycleModelWithSlack (6, 2) and the two
#: bicycles (6, 3). A model with other sizes adds an instantiation there and
#: here.
INSTANTIATED = ((5, 2), (4, 2), (6, 2), (6, 3))


# ---------------------------------------------------------------------------
# Row structure (shared by the kernel and the plain version)
# ---------------------------------------------------------------------------
def _compact_row_meta(row_meta, m):
    """``(row_meta, h_rows)``: each generic row re-mapped to ``("h", slot)``,
    its slot in the compacted D storage."""
    if row_meta is None:
        row_meta = tuple(("h", r) for r in range(m))
    h_rows = tuple(r for r, meta in enumerate(row_meta) if meta[0] == "h")
    row_meta = tuple(("h", h_rows.index(r)) if meta[0] == "h" else meta
                     for r, meta in enumerate(row_meta))
    return row_meta, h_rows


class _Rows(NamedTuple):
    row_meta: tuple  # compacted, one entry per row
    h_rows: tuple  # generic row indices, in D slot order
    stage_mask: np.ndarray  # (T, m) float64
    active: tuple  # rows unmasked at some stage
    n_act: float  # max(number of active (stage, row) pairs, 1)


def _rows(row_mask, row_meta, T, m) -> _Rows:
    if isinstance(row_mask, torch.Tensor):
        row_mask = row_mask.detach().cpu().numpy()
    mask = np.asarray(row_mask, dtype=np.float64)
    if mask.ndim == 3:
        mask = mask[0]
    if m == 0:
        # One all-masked box row: the solve reduces to one exact Riccati pass.
        mask = np.zeros((T, 1))
        row_meta = (("box", 0, 1.0),)
        m = 1
    if mask.shape != (T, m):
        raise ValueError(f"row_mask must be (T, m) = {(T, m)}, got {mask.shape}")
    if row_meta is not None:
        row_meta = tuple(tuple(meta) for meta in row_meta)
        if len(row_meta) != m:
            raise ValueError(f"row_meta has {len(row_meta)} rows, D has {m}")
    meta_c, h_rows = _compact_row_meta(row_meta, m)
    active = tuple(r for r in range(m) if mask[:, r].any())
    return _Rows(meta_c, h_rows, mask, active,
                 max(float(mask.sum()), 1.0))


def _padded_rows(D, e):
    """D (Bt,T,m,nz), e (Bt,T,m) with m == 0 padded to one all-masked row."""
    if D.shape[2] > 0:
        return D, e
    Bt, T, _, nz = D.shape
    return (torch.zeros((Bt, T, 1, nz), dtype=D.dtype, device=D.device),
            torch.ones((Bt, T, 1), dtype=e.dtype, device=e.device))


def _generic_D(D, rows: _Rows):
    """Compacted generic-row storage (Bt, T, max(mh, 1), nz)."""
    if not rows.h_rows:
        Bt, T, _, nz = D.shape
        return torch.zeros((Bt, T, 1, nz), dtype=D.dtype, device=D.device)
    return D.index_select(2, torch.as_tensor(rows.h_rows, device=D.device))


def check_instantiated(nx: int, nu: int):
    """Raise ``ValueError`` unless the kernels are compiled for (nx, nu)."""
    if (nx, nu) not in INSTANTIATED:
        raise ValueError(f"the QP kernel is compiled for (nx, nu) in "
                         f"{INSTANTIATED}, not ({nx}, {nu})")


def _check_inputs(H, g, A, B, c, D, e, r0, nu):
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"QP data must be float32 or float64, got {H.dtype}")
    Bt, T, nz, nz2 = H.shape
    nx = A.shape[-1]
    m = D.shape[2]
    want = {"H": (Bt, T, nz, nz), "g": (Bt, T, nz), "A": (Bt, T - 1, nx, nx),
            "B": (Bt, T - 1, nx, nu), "c": (Bt, T - 1, nx), "D": (Bt, T, m, nz),
            "e": (Bt, T, m), "r0": (Bt, nx)}
    for name, x in zip(want, (H, g, A, B, c, D, e, r0)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
        if x.dtype != H.dtype or x.device != H.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected "
                             f"{H.dtype} on {H.device}")
    if nz != nx + nu or T < 2:
        raise ValueError(f"inconsistent sizes nz={nz}, nx={nx}, nu={nu}, T={T}")
    if not 1 <= nu <= _MAX_NU:
        raise NotImplementedError(f"closed-form SPD inverse covers nu <= 3, got nu={nu}")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------
def _spd_inv(M):
    """Closed-form SPD inverse of (..., n, n) for n in {1, 2, 3}."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a, b, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
        inv_det = 1.0 / (a * d - b * b)
        return torch.stack([torch.stack([d * inv_det, -b * inv_det], -1),
                            torch.stack([-b * inv_det, a * inv_det], -1)], -2)
    if n == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e, f = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
        A00 = d * f - e * e
        A01 = c * e - b * f
        A02 = b * e - c * d
        A11 = a * f - c * c
        A12 = b * c - a * e
        A22 = a * d - b * b
        inv_det = 1.0 / (a * A00 + b * A01 + c * A02)
        return torch.stack([
            torch.stack([A00 * inv_det, A01 * inv_det, A02 * inv_det], -1),
            torch.stack([A01 * inv_det, A11 * inv_det, A12 * inv_det], -1),
            torch.stack([A02 * inv_det, A12 * inv_det, A22 * inv_det], -1)], -2)
    raise NotImplementedError(f"nu={n}")


def _factor(Hbar, A, B, nu):
    """Backward Riccati matrix sweep: per-stage (K, Linv, Qux, P_{k+1})."""
    T = Hbar.shape[1]
    P = Hbar[:, T - 1, nu:, nu:]
    Ks, Linvs, Quxs, Pnexts = [None] * (T - 1), [None] * (T - 1), \
        [None] * (T - 1), [None] * (T - 1)
    for k in range(T - 2, -1, -1):
        A_k, B_k = A[:, k], B[:, k]
        PA = P @ A_k
        PB = P @ B_k
        Quu = Hbar[:, k, :nu, :nu] + B_k.transpose(-1, -2) @ PB
        Qux = Hbar[:, k, :nu, nu:] + B_k.transpose(-1, -2) @ PA
        Qxx = Hbar[:, k, nu:, nu:] + A_k.transpose(-1, -2) @ PA
        Linv = _spd_inv(Quu)
        K = -(Linv @ Qux)
        S = Qxx + Qux.transpose(-1, -2) @ K
        Ks[k], Linvs[k], Quxs[k], Pnexts[k] = K, Linv, Qux, P
        P = 0.5 * (S + S.transpose(-1, -2))
    return Ks, Linvs, Quxs, Pnexts


def _solve_vec(fact, gbar, A, B, rd, r0_res, nu):
    """Vector sweep + forward rollout -> dz (Bt, T, nz)."""
    Ks, Linvs, Quxs, Pnexts = fact
    T = gbar.shape[1]
    p = gbar[:, T - 1, nu:]
    kffs = [None] * (T - 1)
    for k in range(T - 2, -1, -1):
        A_k, B_k = A[:, k], B[:, k]
        beta = p + (Pnexts[k] @ rd[:, k, :, None])[..., 0]
        qu = gbar[:, k, :nu] + (B_k.transpose(-1, -2) @ beta[..., None])[..., 0]
        qx = gbar[:, k, nu:] + (A_k.transpose(-1, -2) @ beta[..., None])[..., 0]
        kff = -(Linvs[k] @ qu[..., None])[..., 0]
        p = qx + (Quxs[k].transpose(-1, -2) @ kff[..., None])[..., 0]
        kffs[k] = kff
    rows = []
    dx = r0_res
    for k in range(T - 1):
        du = (Ks[k] @ dx[..., None])[..., 0] + kffs[k]
        rows.append(torch.cat([du, dx], dim=-1))
        dx = ((A[:, k] @ dx[..., None])[..., 0]
              + (B[:, k] @ du[..., None])[..., 0] + rd[:, k])
    rows.append(torch.cat([torch.zeros_like(du), dx], dim=-1))
    return torch.stack(rows, dim=1)


def _row_matrix(D_h, rows: _Rows, nz):
    """Dense (Bt, T, R, nz) coefficients of the active rows: +-1 at a box
    row's column and 0 elsewhere, a generic row's D slot."""
    Bt, T = D_h.shape[:2]
    G = torch.zeros((Bt, T, len(rows.active), nz), dtype=D_h.dtype,
                    device=D_h.device)
    for i, r in enumerate(rows.active):
        meta = rows.row_meta[r]
        if meta[0] == "box":
            G[:, :, i, meta[1]] = float(meta[2])
        else:
            G[:, :, i, :] = D_h[:, :, meta[1], :]
    return G


def _ip_iterations(H, g, A, B, c, G, e, r0, mask, n_act, *, nu, n_iters, mu0,
                   mu_min, tau, w_max, s_floor, tol_freeze, lam0=None):
    """The interior-point iteration on active rows only.

    H (Bt,T,nz,nz) symmetric; G (Bt,T,R,nz) row coefficients; e (Bt,T,R);
    mask (T,R); lam0 (Bt,T,R) or None (cold start). Returns z (Bt,T,nz) and
    the final multipliers (Bt,T,R)."""
    Bt, T, nz = g.shape
    dtype, dev = g.dtype, g.device
    if G.shape[2] == 0:
        # No active row: equality constrained, one exact Riccati solve.
        return (_solve_vec(_factor(H, A, B, nu), g, A, B, c, r0, nu),
                g.new_zeros((Bt, T, 0)))
    on = mask > 0
    big = torch.tensor(3e38, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def Dz(zv):
        return torch.einsum("btrz,btz->btr", G, zv)

    def ftb(v, dv):
        """Fraction-to-boundary over active (stage, row) pairs -> (Bt,)."""
        ratio = torch.where(dv < 0, -v / torch.clamp(dv, max=-1e-30), big)
        ratio = torch.where(on, ratio, big)
        return torch.amin(ratio, dim=(1, 2))

    if lam0 is None:
        v0 = torch.sqrt(torch.tensor(mu0, dtype=dtype, device=dev))
        s = torch.where(on, torch.maximum(e, v0), one)
        lam = torch.where(on, mu0 / s, zero)
    else:
        # Dual warm start: slacks from the new residuals, floored off the
        # boundary; the carried multipliers clipped to [mu_min, w_max].
        s_wfloor = torch.tensor(10.0 * math.sqrt(mu_min), dtype=dtype,
                                device=dev)
        s = torch.where(on, torch.maximum(e, s_wfloor), one)
        lam = torch.where(on, torch.clamp(lam0, min=mu_min, max=w_max), zero)
    z = torch.zeros((Bt, T, nz), dtype=dtype, device=dev)
    for it in range(n_iters):
        rin = Dz(z) + e - s
        W = torch.clamp(mask * lam / s, max=w_max)
        Hbar = H + torch.einsum("btri,btr,btrj->btij", G, W, G)
        comp = torch.sum(mask * s * lam, dim=(1, 2)) / n_act
        feas = torch.amax(torch.abs(mask * rin), dim=(1, 2))
        fact = _factor(Hbar, A, B, nu)

        rd = (c - z[:, 1:, nu:]
              + (A @ z[:, :-1, nu:, None])[..., 0]
              + (B @ z[:, :-1, :nu, None])[..., 0])
        r0_res = r0 - z[:, 0, nu:]
        Hz_g = g + (H @ z[..., None])[..., 0]

        def gbar_of(rhs3):
            w_vec = mask * (lam * rin - rhs3) / s
            return Hz_g + torch.einsum("btrz,btr->btz", G, w_vec)

        def dlam_of(rhs3, ds):
            return torch.where(on, (rhs3 - s * lam) / s - (lam / s) * ds, zero)

        # ---- affine (predictor) step -------------------------------------
        dz_a = _solve_vec(fact, gbar_of(0.0), A, B, rd, r0_res, nu)
        ds_a = torch.where(on, Dz(dz_a) + rin, zero)
        dlam_a = dlam_of(0.0, ds_a)
        alpha_aff = torch.clamp(torch.minimum(ftb(s, ds_a), ftb(lam, dlam_a)),
                                max=1.0)[:, None, None]
        comp_aff = torch.sum(mask * (s + alpha_aff * ds_a)
                             * (lam + alpha_aff * dlam_a), dim=(1, 2)) / n_act
        sigma = torch.clamp((comp_aff / torch.clamp(comp, min=1e-30)) ** 3,
                            1e-8, 1.0)
        mu = torch.clamp(sigma * comp, min=mu_min)[:, None, None]

        # ---- corrector step ----------------------------------------------
        rhs3 = mu - ds_a * dlam_a
        dz = _solve_vec(fact, gbar_of(rhs3), A, B, rd, r0_res, nu)
        ds = torch.where(on, Dz(dz) + rin, zero)
        dlam = dlam_of(rhs3, ds)
        nan_acc = torch.sum(dz, dim=(1, 2)) + torch.sum(dlam, dim=(1, 2))
        alpha_p = torch.clamp(tau * ftb(s, ds), max=1.0)
        alpha_d = torch.clamp(tau * ftb(lam, dlam), max=1.0)

        eqr = torch.maximum(torch.amax(torch.abs(rd), dim=(1, 2)),
                            torch.amax(torch.abs(r0_res), dim=1))
        done = ((comp < tol_freeze) & (feas < 100.0 * tol_freeze)
                & (eqr < 100.0 * tol_freeze))
        if lam0 is not None and it == 0:
            # Carried duals make comp tiny at dz = 0 while the new QP is
            # unsolved: a warm start runs one full iteration before freezing.
            done = torch.zeros_like(done)
        scale = torch.where(done | torch.isnan(nan_acc), zero, one)
        alpha_p = (alpha_p * scale)[:, None, None]
        alpha_d = (alpha_d * scale)[:, None, None]

        z = z + alpha_p * dz
        s = torch.where(on, torch.clamp(s + alpha_p * ds, min=s_floor), one)
        lam = torch.where(on, torch.clamp(lam + alpha_d * dlam, min=0.0), zero)
    return z, lam


def _reference(Hs, g, A, B, c, D_h, e, r0, rows: _Rows, *, nu, lam0=None,
               **kw):
    """The plain solve on the kernel's inputs: symmetric H, the compacted
    generic rows D_h (Bt,T,max(mh,1),nz), e (Bt,T,m). Returns z and the
    multipliers of every row (Bt,T,m), 0 on inactive rows."""
    act = list(rows.active)
    G = _row_matrix(D_h, rows, g.shape[2])
    mask = torch.as_tensor(rows.stage_mask[:, act], dtype=g.dtype,
                           device=g.device)
    z, lam_a = _ip_iterations(
        Hs, g, A, B, c, G, e[:, :, act], r0, mask, rows.n_act, nu=nu,
        lam0=None if lam0 is None else lam0[:, :, act], **kw)
    lam = torch.zeros_like(e)
    lam[:, :, act] = lam_a
    return z, lam


def ip_solve_reference(H, g, A, B, c, D, e, row_mask, r0, *, nu: int,
                       n_iters: int = 12, mu0: float = 1e2,
                       mu_min: float = 1e-6, tau: float = 0.995,
                       w_max: float = 1e6, s_floor: float = 1e-10,
                       tol_freeze: float = 1e-5, row_meta=None, lam0=None,
                       duals_out: bool = False):
    """Plain PyTorch version of the kernel, on any device; same arguments
    and result as :func:`solve_qp_batched`, or with ``lam0`` / ``duals_out``
    as :func:`solve_qp_batched_duals` (warm start, ``(z, lam)`` out)."""
    _check_inputs(H, g, A, B, c, D, e, r0, nu)
    T, nz = g.shape[1:]
    if (duals_out or lam0 is not None) and D.shape[2] == 0:
        raise ValueError("the dual variants need at least one inequality row "
                         "(m == 0 has no duals)")
    if lam0 is not None and tuple(lam0.shape) != tuple(e.shape):
        raise ValueError(f"lam0 must be {tuple(e.shape)}, got "
                         f"{tuple(lam0.shape)}")
    rows = _rows(row_mask, row_meta, T, D.shape[2])
    D, e = _padded_rows(D, e)
    # The kernel reads H from its upper triangle.
    Hs = torch.triu(H) + torch.triu(H, diagonal=1).transpose(-1, -2)
    z, lam = _reference(
        Hs, g, A, B, c, _generic_D(D, rows), e, r0, rows, nu=nu, lam0=lam0,
        n_iters=n_iters, mu0=mu0, mu_min=mu_min, tau=tau, w_max=w_max,
        s_floor=s_floor, tol_freeze=tol_freeze)
    return (z, lam) if duals_out else z


# ---------------------------------------------------------------------------
# The kernel: build, bind, launch
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels are built from "
                           f"{_CSRC} with the CUDA toolkit")
    return found


class BuildInfo(NamedTuple):
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (register and spill report)


def _digest(src: Path, flags=_NVCC_FLAGS) -> str:
    """Hash of a kernel source, every header beside it and the flags: a
    library is rebuilt when any file it may include changes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


_BUILT: dict = {}


def build_all(names=tuple(KERNELS)) -> dict:
    """Compile the named kernels (``KERNELS``) for sm_90a into
    ``build/torch_kernels/``, one nvcc process per source, all started
    together; reuse a library whose hash is unchanged. Returns
    ``{name: BuildInfo}``; raises if any build fails."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        if name in _BUILT:
            continue
        src = _CSRC / KERNELS[name]
        out = _BUILD_DIR / f"lib{name}_{_digest(src)}.so"
        if out.is_file():
            _BUILT[name] = BuildInfo(str(out), 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {KERNELS[name]} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        _BUILT[name] = BuildInfo(str(out), time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _BUILT[name] for name in names}


def build(name: str = "qp_ip") -> BuildInfo:
    """Build (or reuse) one kernel library; see :func:`build_all`."""
    return build_all((name,))[name]


def require_built(names=tuple(KERNELS)) -> dict:
    """The named libraries as :func:`build_all` left them, without building:
    raises ``RuntimeError`` where ``build/torch_kernels/`` holds no library
    of the current sources. Processes that share one build directory (the
    ranks of a sharded step) call this after their parent has built, so
    that none of them starts nvcc."""
    for name in names:
        if name in _BUILT:
            continue
        out = _BUILD_DIR / f"lib{name}_{_digest(_CSRC / KERNELS[name])}.so"
        if not out.is_file():
            raise RuntimeError(f"{out} is not built: run qp_cuda.build_all "
                               "before starting the processes that load it")
        _BUILT[name] = BuildInfo(str(out), 0.0, "")
    return {name: _BUILT[name] for name in names}


def _bind_qp(lib, suffixes):
    """Argument types of the QP entries (kernel or host build)."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name, n_ptr in (("qp_ip_solve", 11), ("qp_ip_solve_duals", 13)):
        for suffix in suffixes:
            fn = getattr(lib, name + suffix)
            fn.argtypes = [ptr] * n_ptr + [i32] * 8 + [f64] * 7 + [ptr]
            fn.restype = i32


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build("qp_ip").path)
    _bind_qp(lib, ("_f32", "_f64"))
    lib.qp_ip_launch_info.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.qp_ip_launch_info.restype = None
    return lib


#: Fields of a launch plan (``csrc/warp.cuh::plan_out``).
PLAN_FIELDS = ("warps_per_block", "smem_bytes_per_block", "problems_per_sm",
               "registers", "local_bytes", "err")


def launch_info(dtype, duals, T, m, mhp, nx, nu) -> dict:
    """How the QP kernel launches at these sizes, on the current device:
    warps (= problems) per block, dynamic shared memory per block, problems
    resident per SM (the occupancy API), registers and local memory per
    thread (``PLAN_FIELDS``)."""
    check_instantiated(nx, nu)
    out = (ctypes.c_int * 6)()
    _library().qp_ip_launch_info(int(dtype == torch.float64), int(duals), T,
                                 m, mhp, nx, nu, out)
    return dict(zip(PLAN_FIELDS, out))


def _launch_error(entry, err):
    if err == -2:
        return RuntimeError(f"{entry}: one problem's shared-memory footprint "
                            "exceeds what a block may use on this card")
    if err == -3:
        return ValueError(f"{entry}: no kernel instantiation for these "
                          "(nx, nu)")
    return RuntimeError(f"{entry} kernel launch failed with error {err}")


@functools.lru_cache(maxsize=64)
def _row_tables(rows_key, T, m, dtype, device):
    """Device tables of the row structure: stage mask (T*m,) in the QP
    dtype and the per-row int table (m, 4): kind (0 box, 1 generic),
    active, box column or generic D slot, box sign."""
    row_meta, mask_bytes, active = rows_key
    mask = np.frombuffer(mask_bytes, dtype=np.float64).reshape(T, m).copy()
    table = []
    for r, meta in enumerate(row_meta):
        act = int(r in active)
        if meta[0] == "box":
            table.append([0, act, int(meta[1]), int(np.sign(meta[2]))])
        else:
            table.append([1, act, int(meta[1]), 1])
    return (torch.as_tensor(mask.reshape(-1), dtype=dtype, device=device),
            torch.as_tensor(table, dtype=torch.int32, device=device))


def _lanes(x, Bt):
    """Batch-major (Bt, ...) -> field-major contiguous (fields, Bt)."""
    return x.reshape(Bt, -1).t().contiguous()


class QPFields(NamedTuple):
    """A QP batch in the kernel's field-major layout: each field (n, Bt),
    the batch on the trailing axis. H (T*ntri, Bt) holds the upper triangle
    of each stage's Hessian, row by row; g (T*nz, Bt); A ((T-1)*nx*nx, Bt);
    B ((T-1)*nx*nu, Bt); c ((T-1)*nx, Bt); D (T*max(mh,1)*nz, Bt) the
    generic rows only, dense over z; e (T*m, Bt); r0 (nx, Bt)."""

    H: torch.Tensor
    g: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    D: torch.Tensor
    e: torch.Tensor
    r0: torch.Tensor


def _launch(entry, fields: QPFields, rows: _Rows, *, T, nz, nx, nu, n_iters,
            mu0, mu_min, tau, w_max, s_floor, tol_freeze, lam0=None,
            lam_out=None, lib=None):
    """Launch one kernel entry on field-major inputs; returns z (T*nz, Bt).
    CPU tensors run the entry of ``lib``, a host build with the kernel's
    entries (the stream argument is then null)."""
    check_instantiated(nx, nu)
    Bt = fields.g.shape[1]
    m = fields.e.shape[0] // T
    dev, dtype = fields.g.device, fields.g.dtype
    mask_t, table_t = _row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m, dtype,
        dev)
    z = torch.empty((T * nz, Bt), dtype=dtype, device=dev)
    duals = [] if lam_out is None else [lam0, lam_out]
    tensors = [*fields, mask_t, table_t, z, *duals]
    if not all(t is None or (t.is_contiguous() and t.device == dev)
               for t in tensors):
        raise ValueError("kernel buffers must be contiguous and on one device")
    args = ([None if t is None else t.data_ptr() for t in tensors]
            + [Bt, T, nx, nu, m, fields.D.shape[0] // (T * nz),
               int(bool(rows.active)), n_iters, mu0, mu_min, tau, w_max,
               s_floor, tol_freeze, rows.n_act])
    suffix = "_f64" if dtype == torch.float64 else "_f32"
    if dev.type == "cpu":
        err = getattr(lib, entry + "_host" + suffix)(*args, None)
    else:
        fn = getattr(_library(), entry + suffix)
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _launch_error(entry, err)
    return z


def _batch_fields(H, g, A, B, c, D, e, r0, rows: _Rows):
    """Batch-major inputs (``solve_qp_batched``'s) -> :class:`QPFields`."""
    Bt, _, nz, _ = H.shape
    iu, ju = (torch.as_tensor(a, device=H.device) for a in np.triu_indices(nz))
    return QPFields(_lanes(H[..., iu, ju], Bt), _lanes(g, Bt), _lanes(A, Bt),
                    _lanes(B, Bt), _lanes(c, Bt),
                    _lanes(_generic_D(D, rows), Bt), _lanes(e, Bt),
                    _lanes(r0, Bt))


def _cuda_device(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def solve_qp_batched(H, g, A, B, c, D, e, row_mask, r0, *, nu: int,
                     n_iters: int = 12, mu0: float = 1e2, mu_min: float = 1e-6,
                     tau: float = 0.995, w_max: float = 1e6,
                     s_floor: float = 1e-10, tol_freeze: float = 1e-5,
                     row_meta=None):
    """Batched QP solve.

    Inputs carry a leading batch axis: H (Bt,T,nz,nz) (read from its upper
    triangle), g (Bt,T,nz), A (Bt,T-1,nx,nx), B (Bt,T-1,nx,nu), c (Bt,T-1,nx),
    D (Bt,T,m,nz), e (Bt,T,m), r0 (Bt,nx); ``row_mask`` is the (T, m) stage
    activity mask, the same for every problem (a numpy array or tensor).
    Returns z (Bt,T,nz). CUDA tensors go through the kernel, CPU tensors
    through :func:`ip_solve_reference`."""
    global launches
    kw = dict(n_iters=n_iters, mu0=mu0, mu_min=mu_min, tau=tau, w_max=w_max,
              s_floor=s_floor, tol_freeze=tol_freeze)
    if H.device.type == "cpu":
        return ip_solve_reference(H, g, A, B, c, D, e, row_mask, r0, nu=nu,
                                  row_meta=row_meta, **kw)
    _cuda_device(H, "solve_qp_batched")
    _check_inputs(H, g, A, B, c, D, e, r0, nu)
    Bt, T, nz, _ = H.shape
    rows = _rows(row_mask, row_meta, T, D.shape[2])
    D, e = _padded_rows(D, e)
    z = _launch("qp_ip_solve", _batch_fields(H, g, A, B, c, D, e, r0, rows),
                rows, T=T, nz=nz, nx=nz - nu, nu=nu, **kw)
    launches += 1
    return z.t().reshape(Bt, T, nz)


def solve_qp_batched_duals(H, g, A, B, c, D, e, row_mask, r0, *, nu: int,
                           lam0=None, n_iters: int = 12, mu0: float = 1e2,
                           mu_min: float = 1e-6, tau: float = 0.995,
                           w_max: float = 1e6, s_floor: float = 1e-10,
                           tol_freeze: float = 1e-5, row_meta=None):
    """:func:`solve_qp_batched` that also returns the final inequality
    multipliers lam (Bt, T, m), and with ``lam0`` (Bt, T, m) warm-starts
    from them: slacks from the new residuals, floored at 10 sqrt(mu_min),
    multipliers clipped to [mu_min, w_max], and no freeze before the second
    iteration. Returns ``(z, lam)``; raises ``ValueError`` for m == 0."""
    global duals_launches, warm_launches
    if D.shape[2] == 0:
        raise ValueError(
            "solve_qp_batched_duals needs at least one inequality row "
            "(m == 0 has no duals to return); use solve_qp_batched")
    kw = dict(n_iters=n_iters, mu0=mu0, mu_min=mu_min, tau=tau, w_max=w_max,
              s_floor=s_floor, tol_freeze=tol_freeze)
    if H.device.type == "cpu":
        return ip_solve_reference(H, g, A, B, c, D, e, row_mask, r0, nu=nu,
                                  row_meta=row_meta, lam0=lam0,
                                  duals_out=True, **kw)
    _cuda_device(H, "solve_qp_batched_duals")
    _check_inputs(H, g, A, B, c, D, e, r0, nu)
    Bt, T, nz, _ = H.shape
    m = D.shape[2]
    if lam0 is not None:
        if tuple(lam0.shape) != (Bt, T, m) or lam0.dtype != H.dtype:
            raise ValueError(f"lam0 must be {(Bt, T, m)} {H.dtype}, got "
                             f"{tuple(lam0.shape)} {lam0.dtype}")
        lam0 = _lanes(lam0, Bt)
    rows = _rows(row_mask, row_meta, T, m)
    lam = torch.empty((T * m, Bt), dtype=H.dtype, device=H.device)
    z = _launch("qp_ip_solve_duals",
                _batch_fields(H, g, A, B, c, D, e, r0, rows), rows, T=T,
                nz=nz, nx=nz - nu, nu=nu, lam0=lam0, lam_out=lam, **kw)
    duals_launches += 1
    warm_launches += lam0 is not None
    return z.t().reshape(Bt, T, nz), lam.t().reshape(Bt, T, m)


def _field_sizes(f: QPFields, nu):
    """(T, nz, nx, m, mhp) of a :class:`QPFields` batch, checked."""
    nx = f.r0.shape[0]
    nz = nx + nu
    ntri = nz * (nz + 1) // 2
    T = f.g.shape[0] // nz
    Bt = f.g.shape[1]
    m = f.e.shape[0] // max(T, 1)
    mhp = f.D.shape[0] // max(T * nz, 1)
    want = {"H": T * ntri, "g": T * nz, "A": (T - 1) * nx * nx,
            "B": (T - 1) * nx * nu, "c": (T - 1) * nx, "D": T * mhp * nz,
            "e": T * m, "r0": nx}
    for name, x in zip(QPFields._fields, f):
        if x.dim() != 2 or tuple(x.shape) != (want[name], Bt):
            raise ValueError(f"{name} must be {(want[name], Bt)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != f.g.dtype or x.device != f.g.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected "
                             f"{f.g.dtype} on {f.g.device}")
    if f.g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"QP data must be float32 or float64, got {f.g.dtype}")
    if T < 2 or not 1 <= nu <= _MAX_NU or mhp < 1:
        raise ValueError(f"inconsistent sizes T={T}, nu={nu}, D slots {mhp}")
    return T, nz, nx, m, mhp


def _fields_rows(fields: QPFields, stage_mask, nu, row_meta):
    """Checked sizes ``(T, nz, nx, m, mhp)``, the row structure, and the
    fields with m == 0 padded to one all-masked row."""
    T, nz, nx, m, mhp = _field_sizes(fields, nu)
    if m == 0:
        # One all-masked row: the solve reduces to one exact Riccati pass.
        fields = fields._replace(e=fields.g.new_ones((T, fields.g.shape[1])))
    rows = _rows(stage_mask, row_meta, T, m)
    if mhp != max(len(rows.h_rows), 1):
        raise ValueError(f"D must carry the {len(rows.h_rows)} generic rows "
                         f"(at least one slot), got {mhp}")
    return fields, rows, (T, nz, nx, max(m, 1), mhp)


def fields_reference(fields: QPFields, stage_mask, *, nu: int,
                     n_iters: int = 12, mu0: float = 1e2,
                     mu_min: float = 1e-6, tau: float = 0.995,
                     w_max: float = 1e6, s_floor: float = 1e-10,
                     tol_freeze: float = 1e-5, row_meta=None):
    """Plain PyTorch version of :func:`solve_qp_fields`, on any device."""
    fields, rows, (T, nz, nx, m, mhp) = _fields_rows(fields, stage_mask, nu,
                                                     row_meta)
    Bt = fields.g.shape[1]

    def batch(x, *shape):
        return x.t().reshape(Bt, *shape)

    tri = batch(fields.H, T, nz * (nz + 1) // 2)
    Hs = fields.g.new_zeros((Bt, T, nz, nz))
    iu, ju = (torch.as_tensor(a, device=fields.g.device)
              for a in np.triu_indices(nz))
    Hs[..., iu, ju] = tri
    Hs[..., ju, iu] = tri
    z, _ = _reference(
        Hs, batch(fields.g, T, nz), batch(fields.A, T - 1, nx, nx),
        batch(fields.B, T - 1, nx, nu), batch(fields.c, T - 1, nx),
        batch(fields.D, T, mhp, nz), batch(fields.e, T, m),
        batch(fields.r0, nx), rows, nu=nu, n_iters=n_iters, mu0=mu0,
        mu_min=mu_min, tau=tau, w_max=w_max, s_floor=s_floor,
        tol_freeze=tol_freeze)
    return z.reshape(Bt, -1).t()


def solve_qp_fields(fields: QPFields, stage_mask, *, nu: int,
                    n_iters: int = 12, mu0: float = 1e2, mu_min: float = 1e-6,
                    tau: float = 0.995, w_max: float = 1e6,
                    s_floor: float = 1e-10, tol_freeze: float = 1e-5,
                    row_meta=None):
    """Batched QP solve on the kernel's field-major layout
    (:class:`QPFields`; D carries the generic rows, in ``row_meta`` order),
    cold start. Returns z (T*nz, Bt). On a CUDA device it reads the fields
    where they lie (views of one buffer are fine, as long as each field is
    contiguous): no copy, no transpose. CPU tensors go through
    :func:`fields_reference`."""
    global lanes_launches
    kw = dict(n_iters=n_iters, mu0=mu0, mu_min=mu_min, tau=tau, w_max=w_max,
              s_floor=s_floor, tol_freeze=tol_freeze)
    if fields.g.device.type == "cpu":
        return fields_reference(fields, stage_mask, nu=nu, row_meta=row_meta,
                                **kw)
    _cuda_device(fields.g, "solve_qp_fields")
    fields, rows, (T, nz, nx, _, _) = _fields_rows(fields, stage_mask, nu,
                                                   row_meta)
    z = _launch("qp_ip_solve", fields, rows, T=T, nz=nz, nx=nx, nu=nu, **kw)
    lanes_launches += 1
    return z


def solve_qp_lanes(lane_qp, stage_mask, *, nu: int, n_iters: int = 12,
                   mu0: float = 1e2, mu_min: float = 1e-6, tau: float = 0.995,
                   w_max: float = 1e6, s_floor: float = 1e-10,
                   tol_freeze: float = 1e-5, row_meta=None):
    """Batched QP solve on lane-layout fields, the batch on the TRAILING
    axis: ``lane_qp`` is a :class:`.linearize.LaneQP` (H (T,nz,nz,Bt),
    g (T,nz,Bt), A (T-1,nx,nx,Bt), B (T-1,nx,nu,Bt), c (T-1,nx,Bt),
    D (T,max(mh,1),nz,Bt) the generic rows in ``row_meta`` order,
    e (T,m,Bt), r0 (nx,Bt)). Returns dz (T, nz, Bt). The layouts are field-
    major already: reshapes and H's upper triangle, then
    :func:`solve_qp_fields`."""
    T, nz, _, Bt = lane_qp.H.shape
    iu, ju = (torch.as_tensor(a, device=lane_qp.H.device)
              for a in np.triu_indices(nz))
    fields = QPFields(lane_qp.H[:, iu, ju].reshape(-1, Bt),
                      *(x.reshape(-1, Bt).contiguous() for x in lane_qp[1:]))
    z = solve_qp_fields(
        fields, stage_mask, nu=nu, n_iters=n_iters, mu0=mu0, mu_min=mu_min,
        tau=tau, w_max=w_max, s_floor=s_floor, tol_freeze=tol_freeze,
        row_meta=row_meta)
    return z.reshape(T, nz, Bt)


# ---------------------------------------------------------------------------
# The kernels' per-problem code on the host (CPU tests)
# ---------------------------------------------------------------------------
_HOST_SRC = _CSRC / "tmpc_ocp_host.cpp"
_HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def host_compiler():
    """The C++ compiler for :func:`build_host`, or None."""
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


@functools.lru_cache(maxsize=None)
def build_host() -> str:
    """Compile ``csrc/tmpc_ocp_host.cpp`` (the kernels' per-problem code for
    the host) into ``build/torch_kernels/``; reuse an unchanged build."""
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX)")
    out = _BUILD_DIR / f"libtmpc_ocp_host_{_digest(_HOST_SRC, _HOST_FLAGS)}.so"
    if not out.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *_HOST_FLAGS, "-o", str(tmp),
                               str(_HOST_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


@functools.lru_cache(maxsize=None)
def host_library():
    """The host build, loaded, with the QP entries bound (``qp_ip_solve*_host_f64``:
    the kernel's entries with the kernel's arguments, f64)."""
    lib = ctypes.CDLL(build_host())
    _bind_qp(lib, ("_host_f64",))
    return lib


def host_solve_qp_fields(fields: QPFields, stage_mask, *, nu: int,
                         lam0=None, duals_out: bool = False,
                         n_iters: int = 12, mu0: float = 1e2,
                         mu_min: float = 1e-6, tau: float = 0.995,
                         w_max: float = 1e6, s_floor: float = 1e-10,
                         tol_freeze: float = 1e-5, row_meta=None):
    """The QP kernel's entries run by its per-problem code compiled for the
    host, 32 emulated lanes per problem (f64 CPU :class:`QPFields`, the
    kernel's layout): cold and z-only, or with ``duals_out`` / ``lam0``
    (T*m, Bt) the duals entry. Returns z (T*nz, Bt), and with
    ``duals_out`` the multipliers (T*m, Bt)."""
    if fields.g.dtype != torch.float64 or fields.g.device.type != "cpu":
        raise ValueError("the host build runs f64 CPU tensors")
    fields, rows, (T, nz, nx, m, _) = _fields_rows(fields, stage_mask, nu,
                                                   row_meta)
    kw = dict(T=T, nz=nz, nx=nx, nu=nu, n_iters=n_iters, mu0=mu0,
              mu_min=mu_min, tau=tau, w_max=w_max, s_floor=s_floor,
              tol_freeze=tol_freeze, lib=host_library())
    if not (duals_out or lam0 is not None):
        return _launch("qp_ip_solve", fields, rows, **kw)
    lam = torch.empty((T * m, fields.g.shape[1]), dtype=torch.float64)
    z = _launch("qp_ip_solve_duals", fields, rows, lam0=lam0, lam_out=lam,
                **kw)
    return (z, lam) if duals_out else z
