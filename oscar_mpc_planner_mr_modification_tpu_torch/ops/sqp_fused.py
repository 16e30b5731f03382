"""Fused whole-SQP fleet solve: the kernel and its plain twin.

Counterpart of the JAX package's ``ops/sqp_fused.py``. The whole SQP solve of
every problem runs in ONE launch of the Hopper kernel ``csrc/sqp_fused.cu``:
per SQP iteration of each schedule phase it linearizes the OCP in the kernel
(``csrc/tmpc_ocp.cuh``: the stage functions with forward-mode derivatives,
the lane linearizer's semantics), runs the interior-point QP iteration
(``csrc/qp_ip.cuh``, cold start, the phase's iteration count), and takes the
full step, keeping the previous iterate where the sum of the step is NaN;
with ``track_best`` it keeps the best iterate by merit.

- :func:`make_fused_fleet_solver` builds ``solve(all_params, xinit, z_init)
  -> SQPResult``. For CUDA tensors it launches the kernel (built with nvcc
  for ``sm_90a`` at first use, loaded with ctypes); for CPU tensors it runs
  :func:`fused_fleet_reference`. It never falls back: an OCP the kernel's
  header does not cover raises ``NotImplementedError`` and
  ``regularization="mirror"`` raises ``ValueError`` when the solver is
  built; a failed build or launch raises.
- :func:`fused_fleet_reference` is the plain PyTorch version: the same SQP
  with ``torch.func`` linearization (:func:`.sqp._make_machinery`) and
  :func:`.qp_cuda.ip_solve_reference`.
- :func:`linearize_fields` runs the kernel's linearization once (the
  ``sqp_fused_linearize`` entry) on field-major inputs and returns the raw
  QP buffer, which ``backend="lanes"`` hands to the QP kernel as it lies;
  :func:`merit_fields` runs the same entry for the merit terms alone, and
  :func:`linearize` unpacks the buffer so that its derivatives can be checked
  field by field. :func:`linearize_reference` is their plain version and
  :func:`host_linearize` runs the same header compiled for the host with a
  C++ compiler.
- ``launches`` counts solve launches, ``linearize_launches`` linearize
  launches and ``merit_launches`` merit-only launches.

What the header covers (:func:`ocp_tables` checks it): the
``ContouringSecondOrderUnicycleModel``; the objectives ``MPCBaseModule``
(``a``, ``w``, ``(v - v_ref)``), ``ContouringModule`` without a dynamic
velocity reference and ``ConsistencyModule``; the constraints
``GuidanceConstraintModule`` (topology halfspaces plus ellipsoids) and
``EllipsoidConstraintModule``, each with one prediction mode.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import NamedTuple

import numpy as np
import torch

from . import qp_cuda
from .sqp import (QPData, SQPConfig, _f32_safe, _make_machinery, _phases_of,
                  fleet_result)

#: Number of fused-solve kernel launches in this process.
launches = 0
#: Number of linearize-entry kernel launches in this process.
linearize_launches = 0
#: Number of merit-only launches of the linearize entry in this process.
merit_launches = 0

# IP constants of the fused solve (JAX ops/sqp_fused.py::make_fused_fleet_solver).
_IP = dict(mu0=1e2, tau=0.995, s_floor=1e-10, tol_freeze=1e-5)

# Table layout: the contract with csrc/tmpc_ocp.cuh (enums TB_*, FL_*, HK_*,
# ROW_*, RT_*, REG_*).
(TB_FLAGS, TB_NSEG, TB_ACC, TB_ANGVEL, TB_VEL, TB_VREF, TB_CONTOUR, TB_LAG,
 TB_TANGLE, TB_TCONT, TB_CONS_W, TB_PREV_X, TB_PREV_Y, TB_DISC_R,
 TB_OFF_SPLINE, TB_OFF_H, TB_OFF_ROWS, TB_HEADER) = range(18)
FL_BASE, FL_CONTOUR, FL_CONSIST, FL_BODY_TERMINAL = 1, 2, 4, 8
HK_HALFSPACE, HK_ELLIPSOID, H_W = 0, 1, 9
ROW_KINDS = {"hl": 0, "hu": 1, "zl": 2, "zu": 3}
REG_KINDS = {"none": 0, "gershgorin": 1, "levenberg": 2}


class OcpTables(NamedTuple):
    ints: np.ndarray  # int32 table (TB_* header, spline, h rows, QP rows)
    reals: np.ndarray  # float64: dt, reg_eps, levenberg, merit weight, bounds
    reg: int  # REG_* kind
    T: int  # N + 1
    npar: int  # parameters per stage
    m: int  # QP rows per stage
    mh: int  # generic (h) rows among them
    generic: tuple  # QP row index of each generic row, in D slot order


# ---------------------------------------------------------------------------
# What the kernel's header covers
# ---------------------------------------------------------------------------
def _check_model(model):
    from ..models.dynamics import ContouringSecondOrderUnicycleModel

    if (type(model) is not ContouringSecondOrderUnicycleModel
            or model.states != ("x", "y", "psi", "v", "spline")
            or model.inputs != ("a", "w") or model.nx_integrate is not None):
        raise NotImplementedError(
            f"the fused kernel covers ContouringSecondOrderUnicycleModel "
            f"only, not {type(model).__name__}")


def _check_base(module):
    """MPCBaseModule as the factory configures it: w_a a^2, w_w w^2 and
    w_v (v - v_ref)^2 (the forms checked on a sample point)."""
    if (module._variables_per_function != ["a", "w", "v"]
            or module._weights_per_function
            != [["acceleration"], ["angular_velocity"],
                ["velocity", "reference_velocity"]]):
        raise NotImplementedError(
            "the fused kernel covers MPCBaseModule weighing a, w and v "
            "(acceleration, angular_velocity, velocity/reference_velocity)")
    t = functools.partial(torch.tensor, dtype=torch.float64)
    x, w0, w1 = 1.7, 0.3, 0.6
    want = (w0 * x * x, w0 * x * x, w0 * (x - w1) ** 2)
    args = ([t(w0)], [t(w0)], [t(w0), t(w1)])
    for fn, w, expected in zip(module._cost_functions, args, want):
        if abs(float(fn(t(x), w)) - expected) > 1e-12:
            raise NotImplementedError(
                "the fused kernel covers MPCBaseModule's default cost forms "
                "only")


def _constraint_rows(module, idx):
    """The kernel's h-row table entries of one constraint module, in the
    order of its ``get_constraints``."""
    from ..modules import EllipsoidConstraintModule, GuidanceConstraintModule
    from ..modules.linearized_constraints import LinearizedConstraintModule

    if type(module) is GuidanceConstraintModule:
        topo = module.topology_constraints
        if (type(topo) is not LinearizedConstraintModule
                or not topo.use_guidance or topo.use_slack
                or topo.n_discs != 1):
            raise NotImplementedError(
                "the fused kernel covers single-disc topology halfspaces "
                "without slack")
        rows = [[HK_HALFSPACE, idx[f"lin_constraint_{i}_a1"],
                 idx[f"lin_constraint_{i}_a2"], idx[f"lin_constraint_{i}_b"]]
                for i in range(topo.max_obstacles + topo.n_other_halfspaces)]
        return rows + _constraint_rows(module.constraint_submodule, idx)
    if type(module) is EllipsoidConstraintModule:
        if module.max_modes != 1:
            raise NotImplementedError(
                "the fused kernel covers one prediction mode (max_modes=1), "
                f"not {module.max_modes}")
        return [[HK_ELLIPSOID]
                + [idx[f"ellipsoid_obst_{i}_{name}"]
                   for name in ("x", "y", "psi", "major", "minor", "chi", "r")]
                + [idx[f"ego_disc_{d}_offset"]]
                for i in range(module.max_obstacles)
                for d in range(module.n_discs)]
    raise NotImplementedError(
        f"the fused kernel does not cover the constraint module "
        f"{type(module).__name__}")


def ocp_tables(ocp, config: SQPConfig) -> OcpTables:
    """The kernel's tables for one OCP and (f32-safe) config. Raises
    ``ValueError`` for a regularization the kernel does not run and
    ``NotImplementedError`` for an OCP its header does not cover."""
    from ..modules import (ConsistencyModule, ContouringModule,
                           MPCBaseModule)

    if config.regularization not in REG_KINDS:
        raise ValueError(
            "the fused kernel supports elementwise regularizations only "
            f"(gershgorin/levenberg/none), not {config.regularization!r}")
    _check_model(ocp.model)
    idx = ocp.registry.save_map()
    head = [0] * TB_HEADER
    flags, spline, h_rows, seen = 0, [], [], set()
    for module in ocp.modules:
        kind = type(module)
        if module.module_type != "objective":
            h_rows += _constraint_rows(module, idx)
            continue
        if kind in seen:
            raise NotImplementedError(f"{kind.__name__} appears twice")
        seen.add(kind)
        if kind is MPCBaseModule:
            _check_base(module)
            flags |= FL_BASE
            for slot, name in ((TB_ACC, "acceleration"),
                               (TB_ANGVEL, "angular_velocity"),
                               (TB_VEL, "velocity"),
                               (TB_VREF, "reference_velocity")):
                head[slot] = idx[name]
        elif kind is ContouringModule:
            if module.dynamic_velocity_reference:
                raise NotImplementedError(
                    "the fused kernel does not cover "
                    "contouring/dynamic_velocity_reference")
            if module.num_segments < 1:
                raise NotImplementedError("contouring needs a segment")
            flags |= FL_CONTOUR
            for slot, name in ((TB_CONTOUR, "contour"), (TB_LAG, "lag"),
                               (TB_TANGLE, "terminal_angle"),
                               (TB_TCONT, "terminal_contouring")):
                head[slot] = idx[name]
            spline = [[idx[f"spline_{xy}{i}_{c}"] for xy in "xy"
                       for c in "abcd"] + [idx[f"spline{i}_start"]]
                      for i in range(module.num_segments)]
        elif kind is ConsistencyModule:
            flags |= FL_CONSIST
            for slot, name in ((TB_CONS_W, "consistency_weight"),
                               (TB_PREV_X, "prev_traj_x"),
                               (TB_PREV_Y, "prev_traj_y")):
                head[slot] = idx[name]
        else:
            raise NotImplementedError(
                f"the fused kernel does not cover the objective module "
                f"{kind.__name__}")
    if len(h_rows) != ocp.nh:
        raise NotImplementedError(
            f"constraint rows {len(h_rows)} != the OCP's nh {ocp.nh}")
    if any(r[0] == HK_ELLIPSOID for r in h_rows):
        head[TB_DISC_R] = idx["ego_disc_radius"]
    if ocp.settings["N"] - 1 == 1:
        flags |= FL_BODY_TERMINAL  # body stages also carry the terminal terms

    row_spec = ocp.ineq_row_spec()
    if not row_spec:
        raise NotImplementedError("the fused kernel needs inequality rows")
    bounds = {"hl": ocp.lh, "hu": ocp.uh, "zl": ocp.lbz, "zu": ocp.ubz}
    rows = [[ROW_KINDS[k], int(i)] for k, i in row_spec]
    head[TB_FLAGS], head[TB_NSEG] = flags, len(spline)
    head[TB_OFF_SPLINE] = TB_HEADER
    head[TB_OFF_H] = TB_HEADER + 9 * len(spline)
    head[TB_OFF_ROWS] = head[TB_OFF_H] + H_W * len(h_rows)
    h_rows = [r + [0] * (H_W - len(r)) for r in h_rows]
    ints = np.asarray(
        head + [v for r in spline + h_rows + rows for v in r], dtype=np.int32)
    reals = np.asarray(
        [ocp.dt, config.reg_eps, config.levenberg, config.merit_eq_weight]
        + [float(bounds[k][i]) for k, i in row_spec], dtype=np.float64)
    generic = tuple(r for r, (k, _) in enumerate(row_spec) if k in ("hl", "hu"))
    return OcpTables(ints=ints, reals=reals,
                     reg=REG_KINDS[config.regularization], T=ocp.N + 1,
                     npar=ocp.npar, m=len(rows), mh=len(generic), generic=generic)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------
_NU, _NX, _NZ = 2, 5, 7
_NTRI = _NZ * (_NZ + 1) // 2
_TRI = np.triu_indices(_NZ)


def qp_layout(T, m, mh) -> dict:
    """Field offsets of one problem's QP fields (``tmpc::QpLayout``)."""
    sizes = (("H", T * _NTRI), ("g", T * _NZ), ("A", (T - 1) * _NX * _NX),
             ("B", (T - 1) * _NX * _NU), ("c", (T - 1) * _NX),
             ("D", T * max(mh, 1) * _NZ), ("e", T * m), ("r0", _NX))
    out, o = {}, 0
    for name, n in sizes:
        out[name] = o
        o += n
    out["total"] = o
    return out


def _lanes_in(P, xinit, Z):
    """Batch-major (B, T, npar), (B, nx), (B, T, nz) -> the kernel's
    field-major inputs: P field par * T + t, Z field t * nz + i."""
    B = Z.shape[0]
    return (P.permute(2, 1, 0).reshape(-1, B).contiguous(),
            xinit.t().contiguous(), Z.reshape(B, -1).t().contiguous())


def unpack_qp(fields, tables: OcpTables) -> QPData:
    """Field-major QP fields (total, B) -> batch-major :class:`.sqp.QPData`,
    D with every row: generic rows from the kernel's storage, box rows +-1
    at their column at every stage (as ``build_qp`` lays them out)."""
    T, m, mh = tables.T, tables.m, tables.mh
    lay = qp_layout(T, m, mh)
    f = fields.t()
    B = f.shape[0]

    def take(name, *shape):
        n = int(np.prod(shape))
        return f[:, lay[name]:lay[name] + n].reshape(B, *shape)

    Htri = take("H", T, _NTRI)
    H = torch.zeros((B, T, _NZ, _NZ), dtype=f.dtype, device=f.device)
    iu, ju = (torch.as_tensor(a, device=f.device) for a in _TRI)
    H[:, :, iu, ju] = Htri
    H[:, :, ju, iu] = Htri
    D_h = take("D", T, max(mh, 1), _NZ)
    D = torch.zeros((B, T, m, _NZ), dtype=f.dtype, device=f.device)
    rows = tables.ints[tables.ints[TB_OFF_ROWS]:].reshape(-1, 2)
    for r, (kind, i) in enumerate(rows):
        if r in tables.generic:
            D[:, :, r] = D_h[:, :, tables.generic.index(r)]
        else:
            D[:, :, r, i] = 1.0 if kind == ROW_KINDS["zl"] else -1.0
    return QPData(H=H, g=take("g", T, _NZ), A=take("A", T - 1, _NX, _NX),
                  B=take("B", T - 1, _NX, _NU), c=take("c", T - 1, _NX),
                  D=D, e=take("e", T, m), r0=take("r0", _NX))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def linearize_reference(mach, tables: OcpTables, P, xinit, Z):
    """Plain version of :func:`linearize`: ``build_qp`` with the kernel's
    masked stage-N placeholders (generic D rows 0, e 1), and ``merit_of``.
    Returns ``(QPData, merit, cost, eq_res)``."""
    qp = mach.build_qp(Z, P, xinit)
    D, e = qp.D.clone(), qp.e.clone()
    D[:, -1, list(tables.generic)] = 0.0
    e[:, -1] = 1.0
    merit, cost, eq_res, _ = mach.merit_of(Z, P, xinit)
    return qp._replace(D=D, e=e), merit, cost, eq_res


def fused_fleet_reference(mach, config: SQPConfig, P, xinit, Z):
    """Plain PyTorch version of the fused kernel: the same SQP, with
    ``torch.func`` linearization and :func:`.qp_cuda.ip_solve_reference`.
    P (B, T, npar) with stage N repeating N-1, xinit (B, nx), Z (B, T, nz).
    Returns :class:`.sqp.SQPResult`."""
    kw = dict(nu=mach.nu, mu_min=config.mu_min, w_max=config.w_max,
              row_meta=mach.row_meta, **_IP)
    best_Z = Z
    best_merit = mach.merit_of(Z, P, xinit)[0] if config.track_best else None
    for n_sqp, n_qp in _phases_of(config):
        for _ in range(n_sqp):
            qp = mach.build_qp(Z, P, xinit)
            dz = qp_cuda.ip_solve_reference(
                qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask,
                qp.r0, n_iters=n_qp, **kw)
            # A NaN step (failed QP) keeps the previous iterate.
            bad = torch.isnan(torch.sum(dz, dim=(1, 2)))[:, None, None]
            Z = torch.where(bad, Z, Z + dz)
            if config.track_best:
                merit = mach.merit_of(Z, P, xinit)[0]
                better = (merit < best_merit)[:, None, None]
                best_Z = torch.where(better, Z, best_Z)
                best_merit = torch.minimum(merit, best_merit)
    final = best_Z if config.track_best else Z
    _, cost, eq_res, finite = mach.merit_of(final, P, xinit)
    return fleet_result(final, cost, eq_res, finite, config)


# ---------------------------------------------------------------------------
# The kernel: bind, launch
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(qp_cuda.build("sqp_fused").path)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.tmpc_qp_layout.argtypes = [i32, i32, i32, ptr]
    lib.tmpc_qp_layout.restype = None
    lib.sqp_fused_scratch_fields.argtypes = [i32] * 3
    lib.sqp_fused_scratch_fields.restype = i32
    for name in ("sqp_fused_solve_f32", "sqp_fused_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 11 + [i32] * 8 + [f64] * 7 + [ptr]
        fn.restype = i32
    for name in ("sqp_fused_linearize_f32", "sqp_fused_linearize_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        fn.restype = i32
    _check_layout(lib)
    return lib


def _check_layout(lib):
    """The library's QP layout is the one :func:`qp_layout` unpacks."""
    for T, m, mh in ((21, 22, 8), (3, 14, 0)):
        out = (ctypes.c_int * 9)()
        lib.tmpc_qp_layout(T, m, mh, out)
        want = qp_layout(T, m, mh)
        if list(out) != [want[k] for k in ("H", "g", "A", "B", "c", "D", "e",
                                           "r0", "total")]:
            raise RuntimeError(f"QP layout mismatch: {list(out)} vs {want}")


def _device_tables(tables: OcpTables, device):
    return (torch.as_tensor(tables.ints, device=device),
            torch.as_tensor(tables.reals, device=device))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cuda(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernel runs on cuda, not {dev}")
    if not all(t.is_contiguous() and t.device == dev for t in tensors):
        raise ValueError("kernel buffers must be contiguous and on one device")
    if tensors[0].dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64, not {tensors[0].dtype}")


def _shapes(tables, P, xinit, Z):
    B = Z.shape[0]
    want = {"P": (B, tables.T, tables.npar), "xinit": (B, _NX),
            "Z": (B, tables.T, _NZ)}
    for name, x in zip(want, (P, xinit, Z)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
        if x.dtype != Z.dtype or x.device != Z.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected "
                             f"{Z.dtype} on {Z.device}")
    return B


def _linearize_launch(tables: OcpTables, P_f, x_f, Z_f, with_qp: bool):
    B = Z_f.shape[1]
    want = {"P": (tables.npar * tables.T, B), "xinit": (_NX, B),
            "Z": (tables.T * _NZ, B)}
    for name, x in zip(want, (P_f, x_f, Z_f)):
        if tuple(x.shape) != want[name] or x.dtype != Z_f.dtype:
            raise ValueError(f"{name} must be {want[name]} {Z_f.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    dev, dtype = Z_f.device, Z_f.dtype
    lib = _library()
    itab, rtab = _device_tables(tables, dev)
    qp = (torch.empty((qp_layout(tables.T, tables.m, tables.mh)["total"], B),
                      dtype=dtype, device=dev) if with_qp else None)
    mo = torch.empty((3, B), dtype=dtype, device=dev)
    _check_cuda(P_f, x_f, Z_f, mo, *(() if qp is None else (qp,)))
    fn = (lib.sqp_fused_linearize_f64 if dtype == torch.float64
          else lib.sqp_fused_linearize_f32)
    with torch.cuda.device(dev):
        err = fn(*[None if t is None else t.data_ptr()
                   for t in (P_f, x_f, Z_f, qp, mo, itab, rtab)], B,
                 tables.T, tables.m, tables.mh, tables.reg, _stream(dev))
    if err != 0:
        raise RuntimeError(f"sqp_fused_linearize launch failed with error {err}")
    return qp, mo


def linearize_fields(tables: OcpTables, P_f, x_f, Z_f):
    """The kernel's linearization at Z on field-major CUDA inputs: P_f
    (npar*T, B) with field p*T + t (stage N repeating N-1), x_f (nx, B),
    Z_f (T*nz, B). Returns the raw QP buffer (``qp_layout(...)["total"]``,
    B), whose fields the QP kernel reads where they lie, and (merit, cost,
    eq_res) as (3, B)."""
    global linearize_launches
    out = _linearize_launch(tables, P_f, x_f, Z_f, with_qp=True)
    linearize_launches += 1
    return out


def merit_fields(tables: OcpTables, P_f, x_f, Z_f):
    """(merit, cost, eq_res) (3, B) at Z on field-major CUDA inputs: the
    linearize entry with no QP output."""
    global merit_launches
    _, mo = _linearize_launch(tables, P_f, x_f, Z_f, with_qp=False)
    merit_launches += 1
    return mo


def linearize(tables: OcpTables, P, xinit, Z):
    """The kernel's linearization at Z (CUDA tensors; P (B, T, npar) with
    stage N repeating N-1). Returns ``(QPData, merit, cost, eq_res)``."""
    _shapes(tables, P, xinit, Z)
    qp, mo = linearize_fields(tables, *_lanes_in(P, xinit, Z))
    return unpack_qp(qp, tables), mo[0], mo[1], mo[2]


def _solve_kernel(tables, rows, config, phases, P, xinit, Z):
    global launches
    B = _shapes(tables, P, xinit, Z)
    dev, dtype = Z.device, Z.dtype
    T, m = tables.T, tables.m
    lib = _library()
    ins = _lanes_in(P, xinit, Z)
    itab, rtab = _device_tables(tables, dev)
    mask_t, table_t, pairs_t = qp_cuda._row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m, dtype,
        dev)
    phases_t = torch.as_tensor(np.asarray(phases, dtype=np.int32).reshape(-1),
                               device=dev)
    out = torch.empty((T * _NZ + 2, B), dtype=dtype, device=dev)
    scratch = torch.empty((lib.sqp_fused_scratch_fields(T, m, tables.mh), B),
                          dtype=dtype, device=dev)
    bufs = (*ins, out, scratch, mask_t, table_t, pairs_t, itab, rtab, phases_t)
    _check_cuda(*bufs)
    fn = (lib.sqp_fused_solve_f64 if dtype == torch.float64
          else lib.sqp_fused_solve_f32)
    with torch.cuda.device(dev):
        err = fn(*[t.data_ptr() for t in bufs], len(phases), B, T, m,
                 tables.mh, int(bool(rows.active)), int(config.track_best),
                 tables.reg, _IP["mu0"], config.mu_min, _IP["tau"],
                 config.w_max, _IP["s_floor"], _IP["tol_freeze"], rows.n_act,
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"sqp_fused kernel launch failed with error {err}")
    launches += 1
    flat = out.t()
    Zo = flat[:, :T * _NZ].reshape(B, T, _NZ)
    cost, eq_res = flat[:, T * _NZ], flat[:, T * _NZ + 1]
    finite = torch.isfinite(cost) & torch.all(torch.isfinite(Zo), dim=(1, 2))
    return fleet_result(Zo, cost, eq_res, finite, config)


def make_fused_fleet_solver(ocp, config: SQPConfig, *, dtype,
                            device="cuda"):
    """Build the fused fleet solver: ``solve(all_params (B, N, npar),
    xinit (B, nx), z_init (B, N+1, nvar)) -> SQPResult``, the whole solve in
    one kernel launch on a CUDA device, :func:`fused_fleet_reference` on the
    CPU. Raises at build time for an OCP or regularization the kernel does
    not cover, and for ``n_qp_iter_warm > 0`` (its QPs are cold).
    ``solve.reference`` runs the plain version on the same arguments."""
    if config.n_qp_iter_warm > 0:
        raise ValueError("the fused kernel solves its QPs cold; "
                         "n_qp_iter_warm needs backend='pallas'")
    device = torch.device(device)
    config = _f32_safe(config, dtype)
    tables = ocp_tables(ocp, config)
    mach = _make_machinery(ocp, config, dtype, device)
    phases = _phases_of(config)
    rows = qp_cuda._rows(mach.stage_mask, mach.row_meta, tables.T, tables.m,
                         _NZ)

    def inputs(all_params, xinit, z_init):
        all_params = torch.as_tensor(all_params, dtype=dtype, device=device)
        P = torch.cat([all_params, all_params[:, -1:]], dim=1)  # stage N reuses N-1
        return (P, torch.as_tensor(xinit, dtype=dtype, device=device),
                torch.as_tensor(z_init, dtype=dtype, device=device))

    def solve(all_params, xinit, z_init):
        P, xinit, Z = inputs(all_params, xinit, z_init)
        if device.type == "cpu":
            return fused_fleet_reference(mach, config, P, xinit, Z)
        return _solve_kernel(tables, rows, config, phases, P, xinit, Z)

    solve.reference = lambda *args: fused_fleet_reference(
        mach, config, *inputs(*args))
    solve.machinery, solve.tables = mach, tables
    return solve


# ---------------------------------------------------------------------------
# The header on the host (CPU tests)
# ---------------------------------------------------------------------------
_HOST_SRC = qp_cuda._CSRC / "tmpc_ocp_host.cpp"
_HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def host_compiler():
    """The C++ compiler for :func:`build_host`, or None."""
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


@functools.lru_cache(maxsize=None)
def build_host() -> str:
    """Compile ``csrc/tmpc_ocp_host.cpp`` (the kernel's linearization header
    for the host) into ``build/torch_kernels/``; reuse an unchanged build."""
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX)")
    out = qp_cuda._BUILD_DIR / (
        f"libtmpc_ocp_host_{qp_cuda._digest(_HOST_SRC, _HOST_FLAGS)}.so")
    if not out.is_file():
        qp_cuda._BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *_HOST_FLAGS, "-o", str(tmp),
                               str(_HOST_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


def host_linearize(tables: OcpTables, P, xinit, Z):
    """:func:`linearize` run by the header compiled for the host (f64, CPU
    tensors or arrays). Returns ``(QPData, merit, cost, eq_res)``."""
    lib = ctypes.CDLL(build_host())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.tmpc_host_linearize_f64
    fn.argtypes = [ptr] * 7 + [i32] * 5
    fn.restype = None
    f64 = functools.partial(torch.as_tensor, dtype=torch.float64)
    P, xinit, Z = f64(P), f64(xinit), f64(Z)
    B = _shapes(tables, P, xinit, Z)
    ins = _lanes_in(P, xinit, Z)
    qp = torch.empty((qp_layout(tables.T, tables.m, tables.mh)["total"], B),
                     dtype=torch.float64)
    mo = torch.empty((3, B), dtype=torch.float64)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    fn(*[t.data_ptr() for t in (*ins, qp, mo)], itab.ctypes.data,
       rtab.ctypes.data, B, tables.T, tables.m, tables.mh, tables.reg)
    return unpack_qp(qp, tables), mo[0], mo[1], mo[2]
