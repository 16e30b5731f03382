"""Lane-layout SQP linearization: QP fields with the batch on the trailing
axis.

Counterpart of the JAX package's ``ops/linearize.py``, with its layouts at
the public functions. On a CUDA device the work is one launch of the fused
kernel's linearization entry (:func:`.sqp_fused.linearize_fields`, the
kernel's forward-mode derivatives of ``csrc/tmpc_ocp.cuh``), which writes
every QP field in the QP kernel's field-major layout; under ``"mirror"``
that launch is the mirror entry's (``csrc/sqp_linearize_mirror.cu``: each
stage's Hessian replaced by V max(|w|, reg_eps) V^T, by cyclic Jacobi in
the kernel, as the JAX package's ``build_qp`` does with ``eigh``). On the
CPU the plain version runs (:func:`.sqp_fused.linearize_reference`:
``torch.func`` and, under ``"mirror"``, ``torch.linalg.eigh``, with the
kernel's stage-N placeholders, generic D rows 0 and e 1 at stage N, where
the stage mask leaves every row inactive). So the lane path covers the OCPs
the fused kernel covers and raises for others, where the JAX package
traces any elementwise OCP.

- :func:`make_lane_linearizer` builds ``lin(P_cols (npar, T, B),
  Z_fields (T, nz, B), xinit_cols (nx, B)) -> LaneQP``; ``lin.fields`` gives
  the same QP as :class:`.qp_cuda.QPFields` (on the card: views of the
  kernel's output buffer, which :func:`.qp_cuda.solve_qp_fields` reads
  where they lie) with the iterate's (merit, cost, eq_res);
  ``lin.merit_terms`` gives those terms alone.
- :func:`make_lane_merit` builds ``merit(P_cols, Z_fields, xinit_cols) ->
  (merit, cost, eq_res, finite)``, each (B,).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import sqp_fused
from .qp_cuda import QPFields
from .sqp import _f32_safe, _make_machinery


class LaneQP(NamedTuple):
    """QP fields in stage-major layout with a trailing batch axis.

    Shapes: H (T, nz, nz, B), g (T, nz, B), A (T-1, nx, nx, B),
    B (T-1, nx, nu, B), c (T-1, nx, B), D (T, max(mh, 1), nz, B) the generic
    rows only, e (T, m, B), r0 (nx, B).
    """

    H: torch.Tensor
    g: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    D: torch.Tensor
    e: torch.Tensor
    r0: torch.Tensor


def buffer_fields(qp, tables) -> QPFields:
    """The QP fields of the kernel's output buffer (total, B) as row views:
    no copy."""
    lay = sqp_fused.qp_layout(tables.T, tables.m, tables.mh, tables.nx,
                              tables.nu)
    ends = [lay[k] for k in QPFields._fields[1:]] + [lay["total"]]
    return QPFields(*(qp[lay[k]:end] for k, end in zip(QPFields._fields, ends)))


def _qpdata_fields(qp, tables) -> QPFields:
    """Batch-major :class:`.sqp.QPData` (all rows in D) -> :class:`QPFields`."""
    B, nz = qp.g.shape[0], qp.g.shape[-1]
    iu, ju = (torch.as_tensor(a, device=qp.H.device)
              for a in np.triu_indices(nz))
    D_h = (qp.D[:, :, list(tables.generic)] if tables.generic
           else qp.D.new_zeros((B, tables.T, 1, nz)))

    def f(x):
        return x.reshape(B, -1).t()

    return QPFields(f(qp.H[..., iu, ju]), f(qp.g), f(qp.A), f(qp.B), f(qp.c),
                    f(D_h), f(qp.e), f(qp.r0))


def lane_qp(fields: QPFields, T: int) -> LaneQP:
    """:class:`QPFields` -> :class:`LaneQP` (H dense and symmetric)."""
    B = fields.g.shape[1]
    nz, nx = fields.g.shape[0] // T, fields.r0.shape[0]
    nu = nz - nx
    tri = fields.H.reshape(T, nz * (nz + 1) // 2, B)
    H = tri.new_zeros((T, nz, nz, B))
    iu, ju = np.triu_indices(nz)
    H[:, iu, ju] = tri
    H[:, ju, iu] = tri
    return LaneQP(
        H=H, g=fields.g.reshape(T, nz, B),
        A=fields.A.reshape(T - 1, nx, nx, B),
        B=fields.B.reshape(T - 1, nx, nu, B),
        c=fields.c.reshape(T - 1, nx, B),
        D=fields.D.reshape(T, -1, nz, B), e=fields.e.reshape(T, -1, B),
        r0=fields.r0)


def make_lane_linearizer(ocp, config, *, dtype, device="cuda"):
    """Build ``lin(P_cols, Z_fields, xinit_cols) -> LaneQP`` (layouts in
    the module docstring; P's stage-N column repeats stage N-1). Raises
    ``ValueError`` for a regularization other than mirror, gershgorin,
    levenberg or none, and ``NotImplementedError`` for an OCP the fused
    kernel's header does not cover."""
    device = torch.device(device)
    config = _f32_safe(config, dtype)
    tables = sqp_fused.ocp_tables(ocp, config, mirror=True)
    mach = _make_machinery(ocp, config, dtype, device)
    T = tables.T

    def batch_major(P_cols, Z_fields, xinit_cols):
        return (P_cols.permute(2, 1, 0), xinit_cols.t(),
                Z_fields.permute(2, 0, 1))

    def fields(P_cols, Z_fields, xinit_cols):
        """(:class:`QPFields`, (merit, cost, eq_res)) at Z."""
        B = Z_fields.shape[2]
        if Z_fields.device.type == "cpu":
            qp, merit, cost, eq_res = sqp_fused.linearize_reference(
                mach, tables, *batch_major(P_cols, Z_fields, xinit_cols))
            return _qpdata_fields(qp, tables), (merit, cost, eq_res)
        qp, mo = sqp_fused.linearize_fields(
            tables, P_cols.reshape(-1, B), xinit_cols, Z_fields.reshape(-1, B))
        return buffer_fields(qp, tables), (mo[0], mo[1], mo[2])

    def merit_terms(P_cols, Z_fields, xinit_cols):
        """(merit, cost, eq_res) at Z, each (B,)."""
        B = Z_fields.shape[2]
        if Z_fields.device.type == "cpu":
            P, x0, Z = batch_major(P_cols, Z_fields, xinit_cols)
            return mach.merit_of(Z, P, x0)[:3]
        mo = sqp_fused.merit_fields(tables, P_cols.reshape(-1, B), xinit_cols,
                                    Z_fields.reshape(-1, B))
        return mo[0], mo[1], mo[2]

    def lin(P_cols, Z_fields, xinit_cols) -> LaneQP:
        return lane_qp(fields(P_cols, Z_fields, xinit_cols)[0], T)

    lin.fields, lin.merit_terms = fields, merit_terms
    lin.machinery, lin.tables = mach, tables
    return lin


def make_lane_merit(ocp, config, *, dtype, device="cuda"):
    """Per-lane merit on column layouts: ``merit(P_cols, Z_fields,
    xinit_cols) -> (merit, cost, eq_res, finite)``, each (B,); merit is
    cost + merit_eq_weight * max(|dynamics defects|, |xinit - x_0|), inf
    unless cost and Z are finite. Covers what :func:`make_lane_linearizer`
    covers."""
    terms = make_lane_linearizer(ocp, config, dtype=dtype,
                                 device=device).merit_terms

    def merit(P_cols, Z_fields, xinit_cols):
        m, cost, eq_res = terms(P_cols, Z_fields, xinit_cols)
        finite = torch.isfinite(cost) & torch.all(torch.isfinite(Z_fields),
                                                  dim=(0, 1))
        return m, cost, eq_res, finite

    return merit

