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
  for ``sm_90a`` at first use, loaded with ctypes; one warp per problem,
  its state in shared memory); for CPU tensors it runs
  :func:`fused_fleet_reference`. It never falls back: an OCP the kernel's
  header does not cover raises ``NotImplementedError`` and
  ``regularization="mirror"`` raises ``ValueError`` when the solver is
  built; a failed build or launch raises.
- :func:`fused_fleet_reference` is the plain PyTorch version: the same SQP
  with ``torch.func`` linearization (:func:`.sqp._make_machinery`) and
  :func:`.qp_cuda.ip_solve_reference`.
- :func:`linearize_fields` runs the kernel's linearization once (the
  ``sqp_fused_linearize`` entry; for tables of ``ocp_tables(...,
  mirror=True)`` under ``"mirror"`` the ``sqp_linearize_mirror`` entry of
  ``csrc/sqp_linearize_mirror.cu``, which mirrors each stage's Hessian by
  Jacobi before it stores it: one problem per block and each stage on a
  group of lanes while the batch fits one wave of blocks, one warp per
  problem above, :func:`mirror_plan`) on field-major inputs and returns the
  raw QP buffer, which ``backend="lanes"`` hands to the QP kernel as it lies;
  :func:`merit_fields` runs the same entry for the merit terms alone, and
  :func:`linearize` unpacks the buffer so that its derivatives can be checked
  field by field. :func:`linearize_reference` is their plain version and
  :func:`host_linearize` runs the same header compiled for the host with a
  C++ compiler (stage after stage, as the linearize entry's lane group, or
  as the mirror entry's block);
  ``solve.host`` runs the kernel's per-problem code on the host.
- ``launches`` counts solve launches, ``linearize_launches`` linearize
  launches, ``mirror_launches`` those of the mirror entry and
  ``merit_launches`` merit-only launches.

What the header covers (:func:`ocp_tables` checks it): the models
``ContouringSecondOrderUnicycleModel``, ``SecondOrderUnicycleModel``,
``ContouringSecondOrderUnicycleModelWithSlack``, ``BicycleModel2ndOrder``
and the curvature-aware ``BicycleModel2ndOrderCurvatureAware`` and
``ContouringSecondOrderUnicycleModelCurvatureAware`` (``MODELS``; the
kernels are compiled for each); the objectives ``MPCBaseModule`` (``a``,
``w``, on a model with slack optionally ``slack``, and optionally ``(v -
v_ref)``), ``ContouringModule`` and ``CurvatureAwareContouringModule`` (on a
model with a spline state, with or without the dynamic velocity reference of
``PathReferenceVelocityModule``), ``ConsistencyModule`` and ``GoalModule``;
the constraints ``GuidanceConstraintModule`` (topology halfspaces plus its
submodule's rows), ``EllipsoidConstraintModule`` and
``GaussianConstraintModule`` with any number of prediction modes,
``ScenarioConstraintModule`` (on a model with slack),
``ContouringConstraintModule`` (the road widths, beside a contouring
module) and ``DecompConstraintModule``. So it covers the T-MPC++ OCPs, the
five BASELINE configurations (goal, contouring, CC-MPC, T-MPC++ and
SH-MPC), the bicycles and the curvature-aware unicycle.
"""

from __future__ import annotations

import collections
import ctypes
import functools
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
#: Number of launches of the mirror linearize entry in this process.
mirror_launches = 0

# IP constants of the fused solve (JAX ops/sqp_fused.py::make_fused_fleet_solver).
_IP = dict(mu0=1e2, tau=0.995, s_floor=1e-10, tol_freeze=1e-5)

# Table layout: the contract with csrc/tmpc_ocp.cuh (enums TB_*, FL_*, HK_*,
# ROW_*, RT_*, REG_*).
(TB_FLAGS, TB_NSEG, TB_ACC, TB_ANGVEL, TB_VEL, TB_VREF, TB_CONTOUR, TB_LAG,
 TB_TANGLE, TB_TCONT, TB_CONS_W, TB_PREV_X, TB_PREV_Y, TB_DISC_R, TB_MODEL,
 TB_GOAL_W, TB_GOAL_X, TB_GOAL_Y, TB_SLACK, TB_VREF_W, TB_CA_VREF,
 TB_OFF_SPLINE, TB_OFF_H, TB_OFF_ROWS, TB_HEADER) = range(25)
(FL_BASE, FL_CONTOUR, FL_CONSIST, FL_BODY_TERMINAL, FL_GOAL, FL_VSPLINE,
 FL_CA_CONTOUR) = (1, 2, 4, 8, 16, 32, 64)
#: Entries per spline segment row: x_a..x_d, y_a..y_d, start, then the
#: velocity reference's v_a..v_d (from SP_V; 0 without a dynamic velocity
#: reference), the left road width's (from SP_WL) and the right one's (from
#: SP_WR; 0 without road-width rows).
SP_V, SP_WL, SP_WR, SP_W = 9, 13, 17, 21
#: The models the kernels are compiled for (``tmpc::with_model``): class
#: name -> model id.
MODELS = {"ContouringSecondOrderUnicycleModel": 0,
          "SecondOrderUnicycleModel": 1,
          "ContouringSecondOrderUnicycleModelWithSlack": 2,
          "BicycleModel2ndOrder": 3,
          "BicycleModel2ndOrderCurvatureAware": 4,
          "ContouringSecondOrderUnicycleModelCurvatureAware": 5}
(HK_HALFSPACE, HK_ELLIPSOID, HK_GAUSSIAN, HK_SCENARIO, HK_ROADWIDTH, HK_DECOMP,
 H_W) = 0, 1, 2, 3, 4, 5, 9
#: The real table's scalars before the row bounds: dt, reg_eps, levenberg,
#: the merit weight and the road-width rows' half vehicle width.
RT_BOUNDS = 5
ROW_KINDS = {"hl": 0, "hu": 1, "zl": 2, "zu": 3}
REG_KINDS = {"none": 0, "gershgorin": 1, "levenberg": 2}
#: The tables' code for ``"mirror"`` (``csrc/tmpc_ocp.cuh::REG_MIRROR``),
#: which the single-instance kernel and the mirror linearize entry run and
#: the fused solve does not.
REG_MIRROR = 3


class OcpTables(NamedTuple):
    ints: np.ndarray  # int32 table (TB_* header, spline, h rows, QP rows)
    reals: np.ndarray  # float64: dt, reg_eps, levenberg, merit weight, bounds
    reg: int  # REG_* kind
    model: int  # model id (MODELS)
    nx: int  # states
    nu: int  # inputs
    T: int  # N + 1
    npar: int  # parameters per stage
    m: int  # QP rows per stage
    mh: int  # generic (h) rows among them
    generic: tuple  # QP row index of each generic row, in D slot order


# ---------------------------------------------------------------------------
# What the kernel's header covers
# ---------------------------------------------------------------------------
def _check_model(model) -> int:
    """The model's id (``MODELS``); raises ``NotImplementedError`` for a
    model the kernels are not compiled for."""
    from ..models import dynamics

    name = type(model).__name__
    cls = getattr(dynamics, name, None)
    if (name not in MODELS or type(model) is not cls
            or (model.states, model.inputs, model.nx_integrate)
            != (cls.states, cls.inputs, cls.nx_integrate)):
        raise NotImplementedError(
            f"the fused kernel covers the models {sorted(MODELS)}, not "
            f"{name}")
    return MODELS[name]


def _check_base(module) -> tuple:
    """MPCBaseModule as the factories configure it: w_a a^2, w_w w^2,
    optionally w_s slack^2 and optionally w_v (v - v_ref)^2, in that order
    (the forms checked on a sample point). Returns whether it weighs slack
    and whether it weighs v."""
    weights = {"a": ["acceleration"], "w": ["angular_velocity"],
               "slack": ["slack"], "v": ["velocity", "reference_velocity"]}
    forms = (("a", "w"), ("a", "w", "v"), ("a", "w", "slack"),
             ("a", "w", "slack", "v"))
    variables = tuple(module._variables_per_function)
    if (variables not in forms or [weights[v] for v in variables]
            != module._weights_per_function):
        raise NotImplementedError(
            "the fused kernel covers MPCBaseModule weighing a, w, optionally "
            "slack and optionally v (acceleration, angular_velocity, slack, "
            "velocity/reference_velocity)")
    t = functools.partial(torch.tensor, dtype=torch.float64)
    x, w0, w1 = 1.7, 0.3, 0.6
    for fn, var in zip(module._cost_functions, variables):
        w, want = (([t(w0), t(w1)], w0 * (x - w1) ** 2) if var == "v"
                   else ([t(w0)], w0 * x * x))
        if abs(float(fn(t(x), w)) - want) > 1e-12:
            raise NotImplementedError(
                "the fused kernel covers MPCBaseModule's default cost forms "
                "only")
    return "slack" in variables, "v" in variables


def _constraint_rows(module, idx):
    """The kernel's h-row table entries of one constraint module, in the
    order of its ``get_constraints``: one per (obstacle, mode, disc) for
    ellipsoids and Gaussian chance constraints, each row with its own
    parameter indices."""
    from ..modules import (ContouringConstraintModule,
                           DecompConstraintModule, EllipsoidConstraintModule,
                           GaussianConstraintModule, GuidanceConstraintModule,
                           ScenarioConstraintModule)
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
        return [[HK_ELLIPSOID]
                + [idx[module._p(i, j, name)]
                   for name in ("x", "y", "psi", "major", "minor", "chi")]
                + [idx[f"ellipsoid_obst_{i}_r"], idx[f"ego_disc_{d}_offset"]]
                for i in range(module.max_obstacles)
                for j in range(module.max_modes)
                for d in range(module.n_discs)]
    if type(module) is GaussianConstraintModule:
        return [[HK_GAUSSIAN]
                + [idx[module._p(i, j, name)]
                   for name in ("x", "y", "major", "minor", "risk")]
                + [idx[f"gaussian_obst_{i}_r"], idx[f"ego_disc_{d}_offset"]]
                for i in range(module.max_obstacles)
                for j in range(module.max_modes)
                for d in range(module.n_discs)]
    if type(module) is ScenarioConstraintModule:
        if not module.use_slack:
            raise NotImplementedError(
                "the fused kernel covers scenario constraints softened by "
                "the model's slack state")
        return [[HK_SCENARIO]
                + [idx[module._constraint_name(i, d) + suffix]
                   for suffix in ("_a1", "_a2", "_b")]
                + [idx[f"ego_disc_{d}_offset"]]
                for d in range(module.n_discs)
                for i in range(module.n_per_disc)]
    if type(module) is DecompConstraintModule:
        if not module.use_slack:
            raise NotImplementedError(
                "the fused kernel covers decomp rows softened by the model's "
                "slack where it has one")
        return [[HK_DECOMP]
                + [idx[module._constraint_name(i, d) + suffix]
                   for suffix in ("_a1", "_a2", "_b")]
                + [idx[f"ego_disc_{d}_offset"]]
                for d in range(module.n_discs)
                for i in range(module.max_constraints)]
    if type(module) is ContouringConstraintModule:
        # the right width's row, then the left's (get_constraints' order)
        return [[HK_ROADWIDTH, 0], [HK_ROADWIDTH, 1]]
    raise NotImplementedError(
        f"the fused kernel does not cover the constraint module "
        f"{type(module).__name__}")


def ocp_tables(ocp, config: SQPConfig, mirror: bool = False) -> OcpTables:
    """The kernel's tables for one OCP and (f32-safe) config. Raises
    ``ValueError`` for a regularization the kernel does not run and
    ``NotImplementedError`` for an OCP its header does not cover. With
    ``mirror`` (the single-instance kernel, :mod:`.sqp_single`, and the
    linearize entry, :func:`linearize_fields`) ``"mirror"`` is accepted too,
    as ``REG_MIRROR``."""
    from ..modules import (ConsistencyModule, ContouringConstraintModule,
                           ContouringModule, CurvatureAwareContouringModule,
                           GoalModule, MPCBaseModule,
                           PathReferenceVelocityModule)

    reg_kinds = {**REG_KINDS, "mirror": REG_MIRROR} if mirror else REG_KINDS
    if config.regularization not in reg_kinds:
        raise ValueError(
            "the fused kernel supports elementwise regularizations only "
            f"(gershgorin/levenberg/none), not {config.regularization!r}")
    model_id = _check_model(ocp.model)
    idx = ocp.registry.save_map()
    head = [0] * TB_HEADER
    head[TB_MODEL] = model_id
    head[TB_CA_VREF] = -1
    flags, spline, h_rows, seen = 0, [], [], set()
    contouring = None
    for module in ocp.modules:
        kind = type(module)
        if module.module_type != "objective":
            h_rows += _constraint_rows(module, idx)
            continue
        if kind in seen:
            raise NotImplementedError(f"{kind.__name__} appears twice")
        seen.add(kind)
        if kind is MPCBaseModule:
            weighs_slack, weighs_v = _check_base(module)
            flags |= FL_BASE
            head[TB_ACC] = idx["acceleration"]
            head[TB_ANGVEL] = idx["angular_velocity"]
            head[TB_SLACK] = idx["slack"] if weighs_slack else -1
            head[TB_VEL] = idx["velocity"] if weighs_v else -1
            head[TB_VREF] = idx["reference_velocity"] if weighs_v else -1
        elif kind is GoalModule:
            flags |= FL_GOAL
            for slot, name in ((TB_GOAL_W, "goal_weight"),
                               (TB_GOAL_X, "goal_x"), (TB_GOAL_Y, "goal_y")):
                head[slot] = idx[name]
        elif kind in (ContouringModule, CurvatureAwareContouringModule):
            if "spline" not in ocp.model.states:
                raise NotImplementedError(
                    "the fused kernel covers contouring on a model with a "
                    "spline state")
            if module.num_segments < 1:
                raise NotImplementedError("contouring needs a segment")
            if contouring is not None:
                raise NotImplementedError("two contouring modules")
            contouring = module
            vref = module.dynamic_velocity_reference
            if kind is ContouringModule:
                flags |= FL_CONTOUR
                head[TB_LAG] = idx["lag"]
            else:
                # contour distance and projected progress (CA-MPC)
                flags |= FL_CA_CONTOUR
                head[TB_VREF_W] = idx["velocity"]
                if not vref:
                    head[TB_CA_VREF] = idx["reference_velocity"]
            for slot, name in ((TB_CONTOUR, "contour"),
                               (TB_TANGLE, "terminal_angle"),
                               (TB_TCONT, "terminal_contouring")):
                head[slot] = idx[name]
            if vref:
                # w_v (v - v_ref(s))^2 on PathReferenceVelocityModule's
                # spline, as the module's get_value adds it
                if "spline_v0_a" not in idx:
                    raise NotImplementedError(
                        "contouring/dynamic_velocity_reference needs the "
                        "PathReferenceVelocity module's parameters")
                flags |= FL_VSPLINE
                head[TB_VREF_W] = idx["velocity"]
            spline = [[idx[f"spline_{xy}{i}_{c}"] for xy in "xy"
                       for c in "abcd"] + [idx[f"spline{i}_start"]]
                      + ([idx[f"spline_v{i}_{c}"] for c in "abcd"] if vref
                         else [0] * 4) + [0] * 8
                      for i in range(module.num_segments)]
        elif kind is PathReferenceVelocityModule:
            pass  # declares the velocity spline; its own cost is 0
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
    half_width = 0.0
    roads = [m for m in ocp.modules if type(m) is ContouringConstraintModule]
    if roads:
        # the road widths are splines on the contouring path's segments
        if (contouring is None
                or any(m.num_segments != len(spline) for m in roads)):
            raise NotImplementedError(
                "the fused kernel covers road-width rows beside a contouring "
                "module with as many segments")
        for i, row in enumerate(spline):
            row[SP_WL:SP_W] = [idx[f"width_{side}{i}_{c}"]
                               for side in ("left", "right") for c in "abcd"]
        half_width = roads[0].half_width(ocp.settings)
    if any(r[0] in (HK_ELLIPSOID, HK_GAUSSIAN) for r in h_rows):
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
    head[TB_OFF_H] = TB_HEADER + SP_W * len(spline)
    head[TB_OFF_ROWS] = head[TB_OFF_H] + H_W * len(h_rows)
    h_rows = [r + [0] * (H_W - len(r)) for r in h_rows]
    ints = np.asarray(
        head + [v for r in spline + h_rows + rows for v in r] + [ocp.npar],
        dtype=np.int32)
    reals = np.asarray(
        [ocp.dt, config.reg_eps, config.levenberg, config.merit_eq_weight,
         half_width] + [float(bounds[k][i]) for k, i in row_spec],
        dtype=np.float64)
    generic = tuple(r for r, (k, _) in enumerate(row_spec) if k in ("hl", "hu"))
    return OcpTables(ints=ints, reals=reals,
                     reg=reg_kinds[config.regularization], model=model_id,
                     nx=ocp.nx, nu=ocp.nu, T=ocp.N + 1,
                     npar=ocp.npar, m=len(rows), mh=len(generic), generic=generic)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------
def qp_layout(T, m, mh, nx, nu) -> dict:
    """Field offsets of one problem's QP fields (``tmpc::QpLayout`` of a
    model with nx states and nu inputs)."""
    nz = nx + nu
    sizes = (("H", T * nz * (nz + 1) // 2), ("g", T * nz),
             ("A", (T - 1) * nx * nx), ("B", (T - 1) * nx * nu),
             ("c", (T - 1) * nx), ("D", T * max(mh, 1) * nz), ("e", T * m),
             ("r0", nx))
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
    T, m, mh, nx, nu = tables.T, tables.m, tables.mh, tables.nx, tables.nu
    nz = nx + nu
    lay = qp_layout(T, m, mh, nx, nu)
    f = fields.t()
    B = f.shape[0]

    def take(name, *shape):
        n = int(np.prod(shape))
        return f[:, lay[name]:lay[name] + n].reshape(B, *shape)

    Htri = take("H", T, nz * (nz + 1) // 2)
    H = torch.zeros((B, T, nz, nz), dtype=f.dtype, device=f.device)
    iu, ju = (torch.as_tensor(a, device=f.device) for a in np.triu_indices(nz))
    H[:, :, iu, ju] = Htri
    H[:, :, ju, iu] = Htri
    D_h = take("D", T, max(mh, 1), nz)
    D = torch.zeros((B, T, m, nz), dtype=f.dtype, device=f.device)
    off = tables.ints[TB_OFF_ROWS]
    rows = tables.ints[off:off + 2 * tables.m].reshape(-1, 2)
    for r, (kind, i) in enumerate(rows):
        if r in tables.generic:
            D[:, :, r] = D_h[:, :, tables.generic.index(r)]
        else:
            D[:, :, r, i] = 1.0 if kind == ROW_KINDS["zl"] else -1.0
    return QPData(H=H, g=take("g", T, nz), A=take("A", T - 1, nx, nx),
                  B=take("B", T - 1, nx, nu), c=take("c", T - 1, nx),
                  D=D, e=take("e", T, m), r0=take("r0", nx))


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
def _bind(lib, suffixes):
    """Argument types of the solve and linearize entries (kernel or host
    build)."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.tmpc_qp_layout.argtypes = [i32] * 4 + [ptr]
    lib.tmpc_qp_layout.restype = i32
    for suffix in suffixes:
        fn = getattr(lib, "sqp_fused_solve" + suffix)
        fn.argtypes = [ptr] * 9 + [i32] * 9 + [f64] * 7 + [ptr]
        fn.restype = i32
        fn = getattr(lib, "sqp_fused_linearize" + suffix)
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.tmpc_table_layout.argtypes = [ptr]
    lib.tmpc_table_layout.restype = None
    _check_layout(lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = _bind(ctypes.CDLL(qp_cuda.build("sqp_fused").path), ("_f32", "_f64"))
    lib.sqp_fused_launch_info.argtypes = [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2
    lib.sqp_fused_launch_info.restype = None
    return lib


def bind_mirror(lib):
    """Argument types of the mirror entry's library (``lib``: a build of
    ``csrc/sqp_linearize_mirror.cu``)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, "sqp_linearize_mirror" + suffix)
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        fn.restype = i32
        fn = getattr(lib, "sqp_linearize_mirror_as" + suffix)
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        fn.restype = i32
    lib.sqp_linearize_mirror_plan.argtypes = [i32] * 6 + [ptr]
    lib.sqp_linearize_mirror_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _mirror_library():
    return bind_mirror(ctypes.CDLL(qp_cuda.build("sqp_linearize_mirror").path))


@functools.lru_cache(maxsize=None)
def _host_library():
    lib = _bind(ctypes.CDLL(qp_cuda.build_host()), ("_host_f64",))
    fn = lib.sqp_linearize_mirror_block_host_f64
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch_info(dtype, tables: OcpTables) -> tuple:
    """How the solve kernel and the linearize entry launch at the tables'
    sizes, on the current device: two dicts of ``qp_cuda.PLAN_FIELDS``
    (warps per block, shared memory per block, problems resident per SM,
    registers and local memory per thread)."""
    solve, lin = (ctypes.c_int * 6)(), (ctypes.c_int * 6)()
    _library().sqp_fused_launch_info(int(dtype == torch.float64),
                                     tables.model, tables.T, tables.m,
                                     tables.mh, solve, lin)
    return (dict(zip(qp_cuda.PLAN_FIELDS, solve)),
            dict(zip(qp_cuda.PLAN_FIELDS, lin)))


#: The mirror entry's designs (``csrc/sqp_linearize_mirror.cu`` MAP_*):
#: picked by the batch, one warp per problem, one block per problem.
MIRROR_MAPPINGS = {"batch": 0, "warp": 1, "block": 2}


def mirror_plan(dtype, tables: OcpTables, problems: int,
                mapping="batch") -> dict:
    """The design (``"warp"`` or ``"block"``) and launch plan
    (``qp_cuda.PLAN_FIELDS``; for the block design warps per block, shared
    memory per block, blocks per SM) of a launch of the mirror entry at
    ``problems`` problems, on the current device."""
    out = (ctypes.c_int * 7)()
    _mirror_library().sqp_linearize_mirror_plan(
        int(dtype == torch.float64), tables.model, tables.T, tables.m,
        problems, MIRROR_MAPPINGS[mapping], out)
    design = {1: "warp", 2: "block"}.get(out[0], str(out[0]))
    return dict(design=design, **dict(zip(qp_cuda.PLAN_FIELDS, out[1:])))


def _check_layout(lib):
    """The library's table contract is :func:`ocp_tables`' and its QP
    layout of every model is the one :func:`qp_layout` unpacks."""
    from ..models import dynamics

    table = (ctypes.c_int * 6)()
    lib.tmpc_table_layout(table)
    want = [TB_HEADER, SP_W, H_W, FL_VSPLINE, FL_CA_CONTOUR, RT_BOUNDS]
    if list(table) != want:
        raise RuntimeError(f"table layout mismatch: {list(table)} vs {want}")

    for name, model in MODELS.items():
        spec = getattr(dynamics, name)()
        for T, m, mh in ((21, 22, 8), (3, 14, 0)):
            out = (ctypes.c_int * 9)()
            err = lib.tmpc_qp_layout(model, T, m, mh, out)
            want = qp_layout(T, m, mh, spec.nx, spec.nu)
            if err != 0 or list(out) != [want[k] for k in (
                    "H", "g", "A", "B", "c", "D", "e", "r0", "total")]:
                raise RuntimeError(f"QP layout mismatch ({name}, error "
                                   f"{err}): {list(out)} vs {want}")


def _device_tables(tables: OcpTables, device):
    return (torch.as_tensor(tables.ints, device=device),
            torch.as_tensor(tables.reals, device=device))


#: The linearize entries' tables on a device, by tables and device, the
#: latest ``_TABLES_KEPT`` kept (``_launch_tables``).
_TABLES_ON_DEVICE = collections.OrderedDict()
_TABLES_KEPT = 64


def _launch_tables(tables: OcpTables, device):
    """``_device_tables``, uploaded once per tables and device: a copy from
    pageable memory waits for the stream, so one per launch made every
    linearize launch wait for the work before it (and for the copies)."""
    key = (id(tables.ints), id(tables.reals), str(device))
    hit = _TABLES_ON_DEVICE.get(key)
    if hit is None or hit[0] is not tables.ints or hit[1] is not tables.reals:
        hit = (tables.ints, tables.reals, *_device_tables(tables, device))
        _TABLES_ON_DEVICE[key] = hit
        if len(_TABLES_ON_DEVICE) > _TABLES_KEPT:
            _TABLES_ON_DEVICE.popitem(last=False)
    else:
        _TABLES_ON_DEVICE.move_to_end(key)
    return hit[2], hit[3]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_host(*tensors):
    if not all(t.device.type == "cpu" and t.is_contiguous()
               and t.dtype == torch.float64 for t in tensors):
        raise ValueError("the host build runs contiguous f64 CPU tensors")


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
    want = {"P": (B, tables.T, tables.npar), "xinit": (B, tables.nx),
            "Z": (B, tables.T, tables.nx + tables.nu)}
    for name, x in zip(want, (P, xinit, Z)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
        if x.dtype != Z.dtype or x.device != Z.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected "
                             f"{Z.dtype} on {Z.device}")
    return B


def _linearize_launch(tables: OcpTables, P_f, x_f, Z_f, with_qp: bool,
                      host=False, mapping="batch", lib=None):
    B = Z_f.shape[1]
    want = {"P": (tables.npar * tables.T, B), "xinit": (tables.nx, B),
            "Z": (tables.T * (tables.nx + tables.nu), B)}
    for name, x in zip(want, (P_f, x_f, Z_f)):
        if tuple(x.shape) != want[name] or x.dtype != Z_f.dtype:
            raise ValueError(f"{name} must be {want[name]} {Z_f.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    dev, dtype = Z_f.device, Z_f.dtype
    itab, rtab = _launch_tables(tables, dev)
    qp = (torch.empty((qp_layout(tables.T, tables.m, tables.mh, tables.nx,
                                 tables.nu)["total"], B),
                      dtype=dtype, device=dev) if with_qp else None)
    mo = torch.empty((3, B), dtype=dtype, device=dev)
    bufs = (P_f, x_f, Z_f, mo, *(() if qp is None else (qp,)))
    args = [None if t is None else t.data_ptr()
            for t in (P_f, x_f, Z_f, qp, mo, itab, rtab)] + [
                B, tables.T, tables.m, tables.mh, tables.model, tables.reg]
    if host:
        _check_host(*bufs)
        lib = _host_library()
        fn = (lib.sqp_linearize_mirror_block_host_f64 if mapping == "block"
              else lib.sqp_fused_linearize_host_f64)
        err = fn(*args, None)
    else:
        _check_cuda(*bufs)
        suffix = "_f64" if dtype == torch.float64 else "_f32"
        if with_qp and tables.reg == REG_MIRROR:
            fn = getattr(lib or _mirror_library(),
                         "sqp_linearize_mirror_as" + suffix)
            args.append(MIRROR_MAPPINGS[mapping])
        else:
            fn = getattr(_library(), "sqp_fused_linearize" + suffix)
        with torch.cuda.device(dev):
            err = fn(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"linearize entry launch failed with error {err}")
    return qp, mo


def linearize_fields(tables: OcpTables, P_f, x_f, Z_f, mapping="batch",
                     lib=None):
    """The kernel's linearization at Z on field-major CUDA inputs: P_f
    (npar*T, B) with field p*T + t (stage N repeating N-1), x_f (nx, B),
    Z_f (T*nz, B). Returns the raw QP buffer (``qp_layout(...)["total"]``,
    B), whose fields the QP kernel reads where they lie, and (merit, cost,
    eq_res) as (3, B). Under ``REG_MIRROR`` the mirror entry runs, in the
    design the batch picks unless ``mapping`` (``MIRROR_MAPPINGS``) names
    one, from ``lib`` (another build of it, bound by :func:`bind_mirror`)
    where given."""
    global linearize_launches, mirror_launches
    out = _linearize_launch(tables, P_f, x_f, Z_f, with_qp=True,
                            mapping=mapping, lib=lib)
    if tables.reg == REG_MIRROR:
        mirror_launches += 1
    else:
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


def _solve_kernel(tables, rows, config, consts, P, xinit, Z, host=False):
    """One launch of the solve kernel (CUDA tensors), or with ``host`` the
    same entry of the host build (f64 CPU tensors). ``consts`` are the
    kernel's int and real tables and its phase list, on Z's device
    (``make_fused_fleet_solver`` uploads them once per device)."""
    global launches
    B = _shapes(tables, P, xinit, Z)
    dev, dtype = Z.device, Z.dtype
    T, m, nz = tables.T, tables.m, tables.nx + tables.nu
    ins = _lanes_in(P, xinit, Z)
    itab, rtab, phases_t = consts
    mask_t, table_t = qp_cuda._row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m, dtype,
        dev)
    out = torch.empty((T * nz + 2, B), dtype=dtype, device=dev)
    bufs = (*ins, out, mask_t, table_t, itab, rtab, phases_t)
    args = [t.data_ptr() for t in bufs] + [
        phases_t.numel() // 2, B, T, m, tables.mh, tables.model,
        int(bool(rows.active)), int(config.track_best), tables.reg,
        _IP["mu0"], config.mu_min, _IP["tau"], config.w_max, _IP["s_floor"],
        _IP["tol_freeze"], rows.n_act]
    if host:
        _check_host(*ins, out)
        err = _host_library().sqp_fused_solve_host_f64(*args, None)
    else:
        _check_cuda(*bufs)
        lib = _library()
        fn = (lib.sqp_fused_solve_f64 if dtype == torch.float64
              else lib.sqp_fused_solve_f32)
        with torch.cuda.device(dev):
            err = fn(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"sqp_fused kernel launch failed with error {err}")
    launches += not host
    flat = out.t()
    Zo = flat[:, :T * nz].reshape(B, T, nz)
    cost, eq_res = flat[:, T * nz], flat[:, T * nz + 1]
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
    rows = qp_cuda._rows(mach.stage_mask, mach.row_meta, tables.T, tables.m)

    @functools.lru_cache(maxsize=None)
    def consts(dev):
        """The tables and the phase list on ``dev``, uploaded once: a copy
        from pageable memory waits for the stream, so one per launch would
        make every launch wait for the work before it."""
        phases_t = torch.as_tensor(
            np.asarray(phases, dtype=np.int32).reshape(-1), device=dev)
        return (*_device_tables(tables, dev), phases_t)

    def inputs(all_params, xinit, z_init):
        all_params = torch.as_tensor(all_params, dtype=dtype, device=device)
        P = torch.cat([all_params, all_params[:, -1:]], dim=1)  # stage N reuses N-1
        return (P, torch.as_tensor(xinit, dtype=dtype, device=device),
                torch.as_tensor(z_init, dtype=dtype, device=device))

    def solve(all_params, xinit, z_init):
        P, xinit, Z = inputs(all_params, xinit, z_init)
        if device.type == "cpu":
            return fused_fleet_reference(mach, config, P, xinit, Z)
        return _solve_kernel(tables, rows, config, consts(Z.device), P, xinit,
                             Z)

    solve.reference = lambda *args: fused_fleet_reference(
        mach, config, *inputs(*args))
    # the kernel's per-problem code compiled for the host (f64, CPU solver)
    solve.host = lambda *args: _solve_kernel(
        tables, rows, config, consts(torch.device("cpu")),
        *inputs(*args), host=True)
    solve.machinery, solve.tables, solve.consts = mach, tables, consts
    return solve


# ---------------------------------------------------------------------------
# The header on the host (CPU tests)
# ---------------------------------------------------------------------------
host_compiler = qp_cuda.host_compiler
build_host = qp_cuda.build_host


def host_linearize(tables: OcpTables, P, xinit, Z, lanes: bool = False,
                   block: bool = False):
    """:func:`linearize` run by the header compiled for the host (f64, CPU
    tensors or arrays): stage after stage, with ``lanes`` through the
    linearize entry's lane-group code (32 emulated lanes per problem), or
    with ``block`` (tables of ``REG_MIRROR``) through the mirror entry's
    block design (its block's threads in turn). Returns ``(QPData, merit,
    cost, eq_res)``."""
    f64 = functools.partial(torch.as_tensor, dtype=torch.float64)
    P, xinit, Z = f64(P), f64(xinit), f64(Z)
    B = _shapes(tables, P, xinit, Z)
    ins = _lanes_in(P, xinit, Z)
    if lanes or block:
        qp, mo = _linearize_launch(tables, *ins, with_qp=True, host=True,
                                   mapping="block" if block else "batch")
        return unpack_qp(qp, tables), mo[0], mo[1], mo[2]
    lib = ctypes.CDLL(build_host())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.tmpc_host_linearize_f64
    fn.argtypes = [ptr] * 7 + [i32] * 6
    fn.restype = i32
    qp = torch.empty((qp_layout(tables.T, tables.m, tables.mh, tables.nx,
                                tables.nu)["total"], B), dtype=torch.float64)
    mo = torch.empty((3, B), dtype=torch.float64)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    err = fn(*[t.data_ptr() for t in (*ins, qp, mo)], itab.ctypes.data,
             rtab.ctypes.data, B, tables.T, tables.m, tables.mh, tables.model,
             tables.reg)
    if err != 0:
        raise RuntimeError(f"host linearization failed with error {err}")
    return unpack_qp(qp, tables), mo[0], mo[1], mo[2]


def host_mirror_jacobi(H, eps: float):
    """The mirror entry's parallel-ordered Jacobi (its block design's
    ``jacobi_stages``, compiled for the host) on symmetric blocks H
    (count, n, n), n <= 9, f64: V max(|w|, eps) V^T per block, all NaN for a
    block with a non-finite entry."""
    H = np.ascontiguousarray(H, dtype=np.float64)
    count, n, _ = H.shape
    out = np.empty_like(H)
    lib = _host_library()
    fn = lib.mirror_block_jacobi_host_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(H.ctypes.data, count, n, eps, out.ctypes.data) != 0:
        raise ValueError(f"blocks of size {n} (the host build takes 1..9)")
    return out
