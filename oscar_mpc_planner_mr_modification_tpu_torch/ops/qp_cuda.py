"""Batched stagewise interior-point QP: the Hopper kernel and its plain twin.

Counterpart of the JAX package's ``ops/qp_pallas.py`` (cold start, z-only).
Each problem is the stagewise QP over T stages, ``z_k = (u_k, x_k)``:

    min  sum_k 1/2 z_k^T H_k z_k + g_k^T z_k
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 = r0,  D_k z_k + e_k >= 0

solved by a fixed count of Mehrotra predictor-corrector iterations with one
Riccati factorization per iteration, a per-problem freeze on convergence
(complementarity, inequality and equality residuals below tolerance, with no
stationarity term) or on a NaN step, and no best-iterate tracking.

- :func:`solve_qp_batched` takes batch-major tensors. For CUDA tensors it
  launches the kernel ``csrc/qp_ip.cu`` (built with nvcc for ``sm_90a`` at
  first use, loaded with ctypes) on the current stream; for CPU tensors it
  runs :func:`ip_solve_reference`. It never falls back: a kernel that fails to
  build or launch raises.
- :func:`ip_solve_reference` is the plain PyTorch version of the same
  iteration, batched over the leading axis.
- ``launches`` counts kernel launches.

Row structure: ``row_meta`` tags each row ``("box", col, sign)`` for a one-hot
variable bound, or ``("h", slot)`` for a generic row. Generic rows are dense:
every column counts, which is exact because D is 0 off a row's support. The
kernel takes the rows, their (D column, z column) pairs and the (T, m) stage
mask as small device tables, so a later pass that finds each row's column
support needs no kernel change.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

#: Number of kernel launches in this process (the reference does not count).
launches = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Kernel libraries: name -> CUDA source in ``csrc/``.
KERNELS = {"qp_ip": "qp_ip.cu", "sqp_fused": "sqp_fused.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_MAX_NX, _MAX_NU = 8, 3
_RK_W = 6  # ints per row in the kernel's row table


# ---------------------------------------------------------------------------
# Row structure (shared by the kernel and the plain version)
# ---------------------------------------------------------------------------
def _compact_row_meta(row_meta, nz, m):
    """``(row_meta, h_rows)``: each generic row re-mapped to its slot in the
    compacted D storage, with its (D column, z column) pairs (all of them)."""
    if row_meta is None:
        row_meta = tuple(("h", r) for r in range(m))
    h_rows = tuple(r for r, meta in enumerate(row_meta) if meta[0] == "h")
    pairs = tuple((col, col) for col in range(nz))
    row_meta = tuple(("h", h_rows.index(r), pairs) if meta[0] == "h" else meta
                     for r, meta in enumerate(row_meta))
    return row_meta, h_rows


class _Rows(NamedTuple):
    row_meta: tuple  # compacted, one entry per row
    h_rows: tuple  # generic row indices, in D slot order
    stage_mask: np.ndarray  # (T, m) float64
    active: tuple  # rows unmasked at some stage
    n_act: float  # max(number of active (stage, row) pairs, 1)


def _rows(row_mask, row_meta, T, m, nz) -> _Rows:
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
    meta_c, h_rows = _compact_row_meta(row_meta, nz, m)
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
    row's column, the supported D entries of a generic row, 0 elsewhere."""
    Bt, T = D_h.shape[:2]
    G = torch.zeros((Bt, T, len(rows.active), nz), dtype=D_h.dtype,
                    device=D_h.device)
    for i, r in enumerate(rows.active):
        meta = rows.row_meta[r]
        if meta[0] == "box":
            G[:, :, i, meta[1]] = float(meta[2])
        else:
            for u, col in meta[2]:
                G[:, :, i, col] = D_h[:, :, meta[1], u]
    return G


def _ip_iterations(H, g, A, B, c, G, e, r0, mask, n_act, *, nu, n_iters, mu0,
                   mu_min, tau, w_max, s_floor, tol_freeze):
    """The interior-point iteration on active rows only.

    H (Bt,T,nz,nz) symmetric; G (Bt,T,R,nz) row coefficients; e (Bt,T,R);
    mask (T,R). Returns z (Bt,T,nz)."""
    Bt, T, nz = g.shape
    dtype, dev = g.dtype, g.device
    if G.shape[2] == 0:
        # No active row: equality constrained, one exact Riccati solve.
        return _solve_vec(_factor(H, A, B, nu), g, A, B, c, r0, nu)
    on = mask > 0
    big = torch.tensor(3e38, dtype=dtype, device=dev)
    v0 = torch.sqrt(torch.tensor(mu0, dtype=dtype, device=dev))
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def Dz(zv):
        return torch.einsum("btrz,btz->btr", G, zv)

    def ftb(v, dv):
        """Fraction-to-boundary over active (stage, row) pairs -> (Bt,)."""
        ratio = torch.where(dv < 0, -v / torch.clamp(dv, max=-1e-30), big)
        ratio = torch.where(on, ratio, big)
        return torch.amin(ratio, dim=(1, 2))

    s = torch.where(on, torch.maximum(e, v0), one)
    lam = torch.where(on, mu0 / s, zero)
    z = torch.zeros((Bt, T, nz), dtype=dtype, device=dev)
    for _ in range(n_iters):
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
        scale = torch.where(done | torch.isnan(nan_acc), zero, one)
        alpha_p = (alpha_p * scale)[:, None, None]
        alpha_d = (alpha_d * scale)[:, None, None]

        z = z + alpha_p * dz
        s = torch.where(on, torch.clamp(s + alpha_p * ds, min=s_floor), one)
        lam = torch.where(on, torch.clamp(lam + alpha_d * dlam, min=0.0), zero)
    return z


def ip_solve_reference(H, g, A, B, c, D, e, row_mask, r0, *, nu: int,
                       n_iters: int = 12, mu0: float = 1e2,
                       mu_min: float = 1e-6, tau: float = 0.995,
                       w_max: float = 1e6, s_floor: float = 1e-10,
                       tol_freeze: float = 1e-5, row_meta=None):
    """Plain PyTorch version of the kernel, on any device; same arguments
    and result as :func:`solve_qp_batched`."""
    _check_inputs(H, g, A, B, c, D, e, r0, nu)
    T, nz = g.shape[1:]
    rows = _rows(row_mask, row_meta, T, D.shape[2], nz)
    D, e = _padded_rows(D, e)
    act = list(rows.active)
    G = _row_matrix(_generic_D(D, rows), rows, nz)
    # The kernel reads H from its upper triangle.
    Hs = torch.triu(H) + torch.triu(H, diagonal=1).transpose(-1, -2)
    mask = torch.as_tensor(rows.stage_mask[:, act], dtype=H.dtype,
                           device=H.device)
    return _ip_iterations(
        Hs, g, A, B, c, G, e[:, :, act], r0, mask, rows.n_act, nu=nu,
        n_iters=n_iters, mu0=mu0, mu_min=mu_min, tau=tau, w_max=w_max,
        s_floor=s_floor, tol_freeze=tol_freeze)


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


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build("qp_ip").path)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.qp_ip_scratch_fields.argtypes = [i32] * 5
    lib.qp_ip_scratch_fields.restype = i32
    for name in ("qp_ip_solve_f32", "qp_ip_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 13 + [i32] * 10 + [f64] * 7 + [ptr]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=64)
def _row_tables(rows_key, T, m, dtype, device):
    """Device tables of the row structure: stage mask (T*m,) in the QP
    dtype, the per-row int table (m, 6) and the (D column, z column) pairs."""
    row_meta, mask_bytes, active = rows_key
    mask = np.frombuffer(mask_bytes, dtype=np.float64).reshape(T, m).copy()
    table, pairs = [], []
    for r, meta in enumerate(row_meta):
        act = int(r in active)
        if meta[0] == "box":
            table.append([0, act, int(meta[1]), int(np.sign(meta[2])), 0, 0])
        else:
            begin = len(pairs)
            pairs.extend([int(u), int(col)] for u, col in meta[2])
            table.append([1, act, int(meta[1]), 1, begin, len(pairs)])
    pairs = pairs or [[0, 0]]
    return (torch.as_tensor(mask.reshape(-1), dtype=dtype, device=device),
            torch.as_tensor(table, dtype=torch.int32, device=device),
            torch.as_tensor(pairs, dtype=torch.int32, device=device))


def _lanes(x, Bt):
    """Batch-major (Bt, ...) -> field-major contiguous (fields, Bt)."""
    return x.reshape(Bt, -1).t().contiguous()


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
    kw = dict(nu=nu, n_iters=n_iters, mu0=mu0, mu_min=mu_min, tau=tau,
              w_max=w_max, s_floor=s_floor, tol_freeze=tol_freeze,
              row_meta=row_meta)
    if H.device.type == "cpu":
        return ip_solve_reference(H, g, A, B, c, D, e, row_mask, r0, **kw)
    if H.device.type != "cuda":
        raise ValueError(f"solve_qp_batched runs on cuda or cpu, not {H.device}")
    _check_inputs(H, g, A, B, c, D, e, r0, nu)
    Bt, T, nz, _ = H.shape
    nx = nz - nu
    if nx > _MAX_NX:
        raise NotImplementedError(f"the kernel handles nx <= {_MAX_NX}, got {nx}")
    rows = _rows(row_mask, row_meta, T, D.shape[2], nz)
    D, e = _padded_rows(D, e)
    m = D.shape[2]
    D_h = _generic_D(D, rows)
    iu, ju = np.triu_indices(nz)
    dev, dtype = H.device, H.dtype
    mask_t, table_t, pairs_t = _row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m, dtype,
        dev)
    ins = [_lanes(H[..., torch.as_tensor(iu, device=dev),
                    torch.as_tensor(ju, device=dev)], Bt),
           _lanes(g, Bt), _lanes(A, Bt), _lanes(B, Bt), _lanes(c, Bt),
           _lanes(D_h, Bt), _lanes(e, Bt), _lanes(r0, Bt)]
    lib = _library()
    fields = lib.qp_ip_scratch_fields(T, nz, nx, nu, m)
    z_l = torch.empty((T * nz, Bt), dtype=dtype, device=dev)
    scratch = torch.empty((fields, Bt), dtype=dtype, device=dev)
    tensors = ins + [mask_t, table_t, pairs_t, z_l, scratch]
    if not all(t.is_contiguous() and t.device == dev for t in tensors):
        raise ValueError("kernel buffers must be contiguous and on one device")
    fn = lib.qp_ip_solve_f64 if dtype == torch.float64 else lib.qp_ip_solve_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], Bt, T, nz, nx, nu, m,
                 D_h.shape[2], D_h.shape[3], int(bool(rows.active)), n_iters,
                 mu0, mu_min, tau, w_max, s_floor, tol_freeze, rows.n_act,
                 stream)
    if err != 0:
        raise RuntimeError(f"qp_ip kernel launch failed with error {err}")
    launches += 1
    return z_l.t().reshape(Bt, T, nz)
