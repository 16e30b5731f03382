"""S1: the single-instance SQP solve in one launch of a hand-written kernel.

Counterpart of the JAX package's ``ops/sqp.py::make_sqp_solver``, which
jits the whole solve into one XLA program (linearization by autodiff,
``build_qp`` with the ``"mirror"`` eigendecomposition, ``ops/qp.py::
solve_qp`` under ``lax.scan``). Here the whole solve of every problem runs
in ONE launch of ``csrc/sqp_single.cu`` (built with nvcc for ``sm_90a`` at
first use, loaded with ctypes; one thread block per problem, its state in
shared memory): per SQP iteration of each schedule phase the in-kernel
linearization of ``csrc/tmpc_ocp.cuh``, the mirror by cyclic Jacobi where
the regularization is ``"mirror"``, JAX's interior-point QP (the freeze
with its stationarity term, the best-merit iterate) and the full step, kept
back where it has a NaN; with ``track_best`` the best-merit SQP iterate.

- :func:`make_single_solver` builds ``solve(all_params (B, N, npar),
  xinit (B, nx), z_init (B, N+1, nvar)) -> SQPResult``: one launch per
  call on the CUDA device it was built for, every problem solved as alone;
  built for another device, ``solve`` raises (``ops/sqp.py::
  _make_batched_single`` is what picks the plain version there). Inputs
  given as numpy arrays are laid out on the host and uploaded in one copy;
  tensors are moved to the device and laid out there. It never falls
  back: an OCP the kernel's header does not cover raises
  ``NotImplementedError`` when the solver is built, an (nx, nu) it is not
  compiled for ``ValueError``, a failed build or launch ``RuntimeError``.
  ``solve.reference`` runs the plain version
  (:func:`.sqp._make_reference_solver`, which ``make_sqp_solver`` runs on
  the CPU) on the same arguments and device, and ``solve.host`` the
  kernel's per-problem code compiled for the host (f64, CPU);
  ``solve.layout`` and ``solve.launch`` are the call's two halves (the
  input blocks, the launch on them).
- :func:`host_mirror` and :func:`host_solve_qp` run the kernel's mirror and
  QP solve alone, compiled for the host, for the CPU tests.
- ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import qp_cuda, sqp_fused
from .sqp import SQPConfig, SQPResult, _f32_safe, _phases_of

#: Number of S1 kernel launches in this process.
launches = 0

#: JAX ``ops/qp.py::solve_qp``'s constants that ``make_sqp_solver`` leaves
#: at their defaults.
_IP = dict(mu0=1e2, tau=0.995, s_floor=1e-12)


#: (nx, nu) of the models S1 is compiled for (``tmpc::with_model``, whose
#: ids ``sqp_fused.MODELS`` names): the contouring unicycles (5, 2),
#: ``SecondOrderUnicycleModel`` (4, 2), the slack model (6, 2) and the
#: bicycles (6, 3).
INSTANTIATED = ((5, 2), (4, 2), (6, 2), (6, 3))


def check_instantiated(nx: int, nu: int):
    """Raise ``ValueError`` unless S1 is compiled for (nx, nu)."""
    if (nx, nu) not in INSTANTIATED:
        raise ValueError(f"the single-instance kernel is compiled for "
                         f"(nx, nu) in {INSTANTIATED}, not ({nx}, {nu})")


def tol_freeze(mu_min: float) -> float:
    """JAX ``solve_qp``'s default freeze tolerance."""
    return max(10.0 * mu_min, 1e-12)


# ---------------------------------------------------------------------------
# The libraries
# ---------------------------------------------------------------------------
def _bind(lib, suffixes):
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for suffix in suffixes:
        fn = getattr(lib, "sqp_single_solve" + suffix)
        fn.argtypes = [ptr] * 7 + [i32] * 9 + [f64] * 8 + [ptr]
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = _bind(ctypes.CDLL(qp_cuda.build("sqp_single").path),
                ("_f32", "_f64"))
    lib.sqp_single_launch_info.argtypes = [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.sqp_single_launch_info.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _host_library():
    lib = _bind(ctypes.CDLL(qp_cuda.build_host()), ("_host_f64",))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sqp_single_mirror_host_f64.argtypes = [ptr, i32, i32, f64, ptr]
    lib.sqp_single_mirror_host_f64.restype = i32
    lib.sqp_single_qp_host_f64.argtypes = ([ptr] * 10 + [i32] * 6 + [f64] * 7
                                           + [ptr] * 4)
    lib.sqp_single_qp_host_f64.restype = i32
    lib.sqp_single_block_warps_host.argtypes = [i32] * 5
    lib.sqp_single_block_warps_host.restype = i32
    return lib


def launch_info(dtype, tables: sqp_fused.OcpTables, problems: int = 1) -> dict:
    """How S1 launches ``problems`` problems at the tables' sizes on the
    current device (``qp_cuda.PLAN_FIELDS``: warps per block, one problem
    per block, so 32 times that many threads per problem; shared memory per
    block; problems (blocks) resident per SM; registers and local memory
    per thread). The width follows the batch
    (``csrc/sqp_single.cuh::block_warps``)."""
    out = (ctypes.c_int * 6)()
    _library().sqp_single_launch_info(int(dtype == torch.float64),
                                      tables.model, tables.T, tables.m,
                                      tables.mh, problems, out)
    return dict(zip(qp_cuda.PLAN_FIELDS, out))


def block_warps(problems: int, sms: int, per_sm) -> int:
    """``csrc/sqp_single.cuh::block_warps`` from the host build: the warps
    per block S1 runs ``problems`` problems with on ``sms`` SMs where
    ``per_sm`` blocks of 8, 4 and 2 warps are resident per SM (0: none
    fits)."""
    return _host_library().sqp_single_block_warps_host(problems, sms, *per_sm)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------
def _layout_host(tables, all_params, xinit, z_init, np_dtype):
    """Numpy inputs -> the kernel's (B, npar*T + nx + T*nz) input blocks:
    P with field p*T + t (stage N repeating N-1), x0, Z."""
    T, nx, npar = tables.T, tables.nx, tables.npar
    nz = nx + tables.nu
    P = np.asarray(all_params, dtype=np_dtype)
    x = np.asarray(xinit, dtype=np_dtype)
    Z = np.asarray(z_init, dtype=np_dtype)
    _check_shapes(tables, P.shape, x.shape, Z.shape)
    B = P.shape[0]
    buf = np.empty((B, npar * T + nx + T * nz), dtype=np_dtype)
    buf[:, :npar * T] = np.concatenate(
        [P, P[:, -1:]], axis=1).transpose(0, 2, 1).reshape(B, -1)
    buf[:, npar * T:npar * T + nx] = x
    buf[:, npar * T + nx:] = Z.reshape(B, -1)
    return buf


def _layout_device(tables, all_params, xinit, z_init):
    """Tensor inputs on one device -> the kernel's input blocks there."""
    _check_shapes(tables, all_params.shape, xinit.shape, z_init.shape)
    B = all_params.shape[0]
    P = torch.cat([all_params, all_params[:, -1:]], dim=1)
    return torch.cat([P.transpose(1, 2).reshape(B, -1), xinit,
                      z_init.reshape(B, -1)], dim=1).contiguous()


def _check_shapes(tables, p_shape, x_shape, z_shape):
    B = z_shape[0] if len(z_shape) else 0
    N, nz = tables.T - 1, tables.nx + tables.nu
    want = {"all_params": (B, N, tables.npar), "xinit": (B, tables.nx),
            "z_init": (B, tables.T, nz)}
    for name, got in zip(want, (p_shape, x_shape, z_shape)):
        if tuple(got) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(got)}")
    if B < 1:
        raise ValueError("the single-instance kernel needs a problem")


def _result(out, T, nz) -> SQPResult:
    """SQPResult fields of the kernel's (B, T*nz + 5) output blocks."""
    n = T * nz
    return SQPResult(z=out[:, :n].reshape(out.shape[0], T, nz),
                     cost=out[:, n], eq_res=out[:, n + 1],
                     qp_comp=out[:, n + 2],
                     success=out[:, n + 4] > 0.5,
                     exit_code=out[:, n + 3].to(torch.int32))


def make_single_solver(ocp, config: SQPConfig = SQPConfig(), *, dtype,
                       device="cuda"):
    """Build S1's solve for one OCP, config and dtype (see the module
    docstring). Raises here for what the kernel does not cover; the kernel
    library is loaded (and, where ``build/torch_kernels/`` holds none of
    the current sources, built) at the first launch, as JAX compiles at the
    first call."""
    from .sqp import _make_machinery, _make_reference_solver

    device = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64, not {dtype}")
    check_instantiated(ocp.nx, ocp.nu)
    config = _f32_safe(config, dtype)
    tables = sqp_fused.ocp_tables(ocp, config, mirror=True)
    T, nz = tables.T, tables.nx + tables.nu
    mach = _make_machinery(ocp, config, dtype, device)
    rows = qp_cuda._rows(mach.stage_mask, mach.row_meta, T, tables.m)
    phases = _phases_of(config)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    scalars = (config.track_best, tables.reg, _IP["mu0"], config.mu_min,
               _IP["tau"], config.w_max, _IP["s_floor"],
               tol_freeze(config.mu_min), rows.n_act, config.res_eq_tol)

    @functools.lru_cache(maxsize=None)
    def consts(dev, host=False):
        """The tables, row tables and phase list on ``dev``, uploaded once
        per solver and device."""
        itab, rtab = sqp_fused._device_tables(tables, dev)
        phases_t = torch.as_tensor(
            np.asarray(phases, dtype=np.int32).reshape(-1), device=dev)
        mask_t, table_t = qp_cuda._row_tables(
            (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T,
            tables.m, torch.float64 if host else dtype, dev)
        return itab, rtab, phases_t, mask_t, table_t

    width = tables.npar * T + tables.nx + T * nz

    def launch(x_in, host=False, lib=None):
        """One launch on the input blocks ``x_in`` (B, width): the kernel's
        on a CUDA tensor (from ``lib`` where given: a variant's library,
        as ``tools/s1_sections.py`` builds one), with ``host`` the host
        build's on a CPU one."""
        global launches
        want = (torch.float64, "cpu") if host else (dtype, "cuda")
        if ((x_in.dtype, x_in.device.type) != want or x_in.dim() != 2
                or x_in.shape[1] != width or not x_in.is_contiguous()):
            raise ValueError(f"S1 takes contiguous (B, {width}) {want[0]} "
                             f"input blocks on {want[1]}, got "
                             f"{tuple(x_in.shape)} {x_in.dtype} on "
                             f"{x_in.device}")
        B, dev = x_in.shape[0], x_in.device
        out = torch.empty((B, T * nz + 5), dtype=x_in.dtype, device=dev)
        itab, rtab, phases_t, mask_t, table_t = consts(dev, host)
        args = [t.data_ptr() for t in (x_in, out, mask_t, table_t, itab,
                                       rtab, phases_t)] + [
            phases_t.numel() // 2, B, T, tables.m, tables.mh, tables.npar,
            tables.model, *scalars]
        if host:
            err = _host_library().sqp_single_solve_host_f64(*args, None)
        else:
            lib = lib or _library()
            fn = (lib.sqp_single_solve_f64 if dtype == torch.float64
                  else lib.sqp_single_solve_f32)
            with torch.cuda.device(dev):
                err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise qp_cuda._launch_error("sqp_single", err)
        launches += not host
        return _result(out, T, nz)

    @functools.lru_cache(maxsize=None)
    def reference_solver():
        return _make_reference_solver(ocp, config, dtype, device)

    def layout(all_params, xinit, z_init):
        """The kernel's input blocks on ``device`` (numpy inputs: laid out
        on the host, then one copy; tensors: moved there, then laid out)."""
        args = (all_params, xinit, z_init)
        if not any(isinstance(a, torch.Tensor) for a in args):
            return torch.as_tensor(_layout_host(tables, *args, np_dtype),
                                   device=device)
        return _layout_device(tables, *(torch.as_tensor(
            a, dtype=dtype, device=device) for a in args))

    def solve(all_params, xinit, z_init) -> SQPResult:
        if device.type != "cuda":
            raise ValueError(f"the single-instance kernel runs on cuda, not "
                             f"{device}: its plain version is "
                             f"solve.reference, its host build solve.host")
        return launch(layout(all_params, xinit, z_init))

    def host(all_params, xinit, z_init) -> SQPResult:
        """The kernel's per-problem code compiled for the host (f64), each
        problem on the emulated warps an H100 would run the batch with
        (``block_warps``, 132 SMs, registers bounding the blocks)."""
        if dtype != torch.float64:
            raise ValueError("the host build runs f64")
        f64 = functools.partial(torch.as_tensor, dtype=torch.float64)
        x_in = _layout_device(tables, f64(all_params), f64(xinit),
                              f64(z_init))
        return launch(x_in, host=True)

    solve.reference = lambda *args: reference_solver()(*args)
    solve.host, solve.layout, solve.launch = host, layout, launch
    solve.tables, solve.machinery = tables, mach
    return solve


# ---------------------------------------------------------------------------
# The kernel's parts alone on the host (CPU tests)
# ---------------------------------------------------------------------------
def host_mirror(H, eps: float) -> np.ndarray:
    """``csrc/sqp_single.cuh::mirror_stage`` on symmetric blocks H (..., n,
    n) (their upper triangles are read), compiled for the host (f64)."""
    H = np.ascontiguousarray(H, dtype=np.float64)
    n = H.shape[-1]
    flat = H.reshape(-1, n, n)
    out = np.empty_like(flat)
    err = _host_library().sqp_single_mirror_host_f64(
        flat.ctypes.data, flat.shape[0], n, eps, out.ctypes.data)
    if err != 0:
        raise ValueError(f"host mirror of {n} x {n} blocks failed ({err})")
    return out.reshape(H.shape)


def host_solve_qp(H, g, A, B, c, D, e, row_mask, r0, *, nu: int,
                  n_iters: int = 15, mu_min: float = 1e-9,
                  w_max: float = 1e14, row_meta=None):
    """``csrc/sqp_single.cuh::solve_qp_problem`` on one QP, compiled for the
    host and run on 8 emulated warps: the arguments of JAX's ``solve_qp`` as
    numpy arrays (H (T, nz, nz) symmetric, D (T, m, nz), ...), ``row_meta``
    as ``qp_cuda`` takes it (every row generic when None). Returns ``(z, s, lam, comp, eq_res)``."""
    f = functools.partial(np.asarray, dtype=np.float64)
    H, g, A, B, c, D, e, r0 = (f(x) for x in (H, g, A, B, c, D, e, r0))
    T, m, nz = D.shape
    nx = nz - nu
    rows = qp_cuda._rows(f(row_mask), row_meta, T, m)
    iu = np.triu_indices(nz)
    Hp = np.ascontiguousarray(H[:, iu[0], iu[1]])
    D_h = (np.zeros((T, 1, nz)) if not rows.h_rows
           else np.ascontiguousarray(D[:, list(rows.h_rows), :]))
    mask_t, table_t = qp_cuda._row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m,
        torch.float64, torch.device("cpu"))
    mask_a, table_a = mask_t.numpy(), table_t.numpy()
    z = np.empty((T, nz))
    s, lam = np.empty((T, m)), np.empty((T, m))
    comp_eq = np.empty(2)
    arrays = [np.ascontiguousarray(x) for x in (Hp, g, A, B, c, D_h, e, r0)]
    err = _host_library().sqp_single_qp_host_f64(
        *[a.ctypes.data for a in arrays], mask_a.ctypes.data,
        table_a.ctypes.data, T, nx, nu, m, D_h.shape[1], n_iters,
        _IP["mu0"], mu_min, _IP["tau"], w_max, _IP["s_floor"],
        tol_freeze(mu_min), rows.n_act, z.ctypes.data, s.ctypes.data,
        lam.ctypes.data, comp_eq.ctypes.data)
    if err != 0:
        raise qp_cuda._launch_error("sqp_single_qp (host)", err)
    return z, s, lam, float(comp_eq[0]), float(comp_eq[1])
