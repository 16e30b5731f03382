"""The port's QP, fused and mirror linearize kernels against their plain
versions on small fleets, short enough to run under NVIDIA's race and
memory checkers.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.kernel_check
    compute-sanitizer --tool racecheck python -m \\
        oscar_mpc_planner_mr_modification_tpu_torch.tools.kernel_check
    compute-sanitizer --tool memcheck python -m \\
        oscar_mpc_planner_mr_modification_tpu_torch.tools.kernel_check

On the first ``BATCH`` (8) problems of the bench fleet (N=20), at f64 and
f32: B1's three entries (cold; duals out, then warm from them on the
re-linearized QPs; the field entry on B2's linearize buffer), B2's linearize
entry and B2's whole solve (with and without track_best), each against its
plain version. Then, at f64, ``BATCH`` problems of each fleet in ``CASES``
(``tools/bench_matrix.py``'s builders, the evaluators' operating point): B2's
linearize entry and whole solve on every other model of its header (the goal
unicycle, the SH-MPC slack model, both bicycles, the curvature-aware
unicycle) and every other h-row kind (Gaussian, scenario, road width,
decomp), and B1's cold entry at its other instances (4, 2), (6, 2) and
(6, 3). On the bench fleet and on every fleet of ``CASES`` the mirror
linearize entry (``csrc/sqp_linearize_mirror.cu``) runs in each of its
designs (``MIRROR_DESIGNS``: one warp per problem, one block per problem)
against its plain version (``torch.func`` and ``eigh``), so nz = 6, 7, 8
and 9 and the terminal stage's x block are covered. f64 is held to
``chip_smoke.py``'s gates (``common.py``: ``QP_F64_GATE``,
``LIN_F64_RTOL`` / ``LIN_F64_ATOL``, ``FUSED_F64_GATE`` with the same
success mask); f32 is reported. Build the kernels first
(``qp_cuda.build_all()``, or any earlier run): the checkers then see no
compiler. Prints one JSON line; exits with code 1 if an f64 gate fails and 2
without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops import qp_cuda, sqp_fused
from ..ops.linearize import make_lane_linearizer
from ..ops.sqp import QPData, _f32_safe, _make_machinery, make_fleet_sqp_solver
from ..parallel.rollout import _default_rollout_config as matrix_config
from . import bench_matrix
from .common import (FUSED_F64_GATE, LIN_F64_ATOL, LIN_F64_RTOL, QP_F64_GATE,
                     bench_config, bench_fleet, card_line, require_card)

#: Problems checked: few enough for the checkers' slowdown.
BATCH = 8
#: The other fleets: name -> (builder of ``(ocp, P, x0, Z)`` numpy on
#: ``BATCH`` problems from ``tools/bench_matrix.py``, whether B1 runs on it).
CASES = {
    "goal": (lambda rng: bench_matrix.build_goal(20, BATCH, rng), True),
    "ccmpc": (lambda rng: bench_matrix.build_ccmpc(20, BATCH, rng), True),
    "shmpc": (lambda rng: bench_matrix.build_shmpc(20, BATCH, rng), True),
    "bicycle": (lambda rng: bench_matrix.build_bicycle(30, BATCH, rng), True),
    "bicycle_ca": (lambda rng: bench_matrix.build_bicycle(
        30, BATCH, rng, curvature_aware=True), True),
    "road_width": (lambda rng: bench_matrix.build_bicycle(
        30, BATCH, rng, road_width=True), False),
    "ca_unicycle": (lambda rng: bench_matrix.build_ca_unicycle(
        20, BATCH, rng), False),
    "decomp": (lambda rng: bench_matrix.build_decomp(20, BATCH, rng), False),
}


#: The mirror entry's designs, each launched on every fleet.
MIRROR_DESIGNS = ("warp", "block")


def check_mirror(ocp, cfg, Pt, x0, Z) -> dict:
    """The mirror linearize entry in each design against its plain version
    on one fleet (P with stage N): at f64 whether every field is within
    the f64 gate, at f32 the largest relative error over the fields."""
    lin = make_lane_linearizer(ocp, cfg._replace(regularization="mirror"),
                               dtype=Z.dtype, device=Z.device)
    ins = sqp_fused._lanes_in(Pt, x0, Z)
    want = sqp_fused.linearize_reference(lin.machinery, lin.tables, Pt, x0,
                                         Z)
    want = tuple(want[0]) + tuple(want[1:])
    out = {}
    for design in MIRROR_DESIGNS:
        qp, mo = sqp_fused.linearize_fields(lin.tables, *ins, mapping=design)
        got = tuple(sqp_fused.unpack_qp(qp, lin.tables)) + (mo[0], mo[1],
                                                             mo[2])
        if Z.dtype == torch.float64:
            out[f"mirror_{design}_ok_f64_gate"] = all(
                torch.allclose(a, b, rtol=LIN_F64_RTOL, atol=LIN_F64_ATOL)
                for a, b in zip(got, want))
        else:
            out[f"mirror_{design}"] = max(_rel(a, b) for a, b in zip(got,
                                                                      want))
    return out


def _rel(a, b):
    """max|a - b| / (1 + max|b|), NaN on both sides counting as equal."""
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(a),
                    (a - b).abs())
    return d.max().item() / (1.0 + torch.nan_to_num(b).abs().max().item())


def check(dtype) -> dict:
    """Every kernel entry against its plain version; relative errors."""
    dev = torch.device("cuda")
    cfg = bench_config()
    ocp, (params, xinit, z_init, _) = bench_fleet(1 + (BATCH - 1) // 9, dtype,
                                                  dev)
    Pn = params.shape[1]
    P = params.reshape(-1, *params.shape[2:])[:BATCH]
    x0 = xinit.repeat_interleave(Pn, dim=0)[:BATCH]
    Z = z_init.reshape(-1, *z_init.shape[2:])[:BATCH]
    Pt = torch.cat([P, P[:, -1:]], dim=1)
    mach = _make_machinery(ocp, _f32_safe(cfg, dtype), dtype, dev)
    qp = mach.build_qp(Z, Pt, x0)
    args = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask, qp.r0)
    kw = dict(nu=mach.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
              row_meta=mach.row_meta)
    out = {}
    out["qp_ip"] = _rel(qp_cuda.solve_qp_batched(*args, **kw),
                        qp_cuda.ip_solve_reference(*args, **kw))
    z_k, lam_k = qp_cuda.solve_qp_batched_duals(*args, **kw)
    z_p, lam_p = qp_cuda.ip_solve_reference(*args, duals_out=True, **kw)
    out["qp_ip_duals_z"], out["qp_ip_duals_lam"] = _rel(z_k, z_p), _rel(
        lam_k, lam_p)
    lam1 = torch.nan_to_num(lam_p, nan=1.0)
    qp1 = mach.build_qp(Z + torch.nan_to_num(z_p), Pt, x0)
    args1 = (qp1.H, qp1.g, qp1.A, qp1.B, qp1.c, qp1.D, qp1.e,
             mach.stage_mask, qp1.r0)
    z_k, lam_k = qp_cuda.solve_qp_batched_duals(*args1, lam0=lam1, **kw)
    z_p, lam_p = qp_cuda.ip_solve_reference(*args1, lam0=lam1,
                                            duals_out=True, **kw)
    out["qp_ip_warm_z"], out["qp_ip_warm_lam"] = _rel(z_k, z_p), _rel(
        lam_k, lam_p)

    lin = make_lane_linearizer(ocp, cfg, dtype=dtype, device=dev)
    fields, _ = lin.fields(Pt.permute(2, 1, 0).contiguous(),
                           Z.permute(1, 2, 0).contiguous(),
                           x0.t().contiguous())
    mask = lin.machinery.stage_mask
    out["qp_ip_lanes"] = _rel(qp_cuda.solve_qp_fields(fields, mask, **kw),
                              qp_cuda.fields_reference(fields, mask, **kw))

    fused = make_fleet_sqp_solver(ocp, cfg, dtype=dtype, device=dev,
                                  backend="fused")
    got = sqp_fused.linearize(fused.tables, Pt, x0, Z)
    want = sqp_fused.linearize_reference(fused.machinery, fused.tables, Pt,
                                         x0, Z)
    flat = zip(QPData._fields + ("merit", "cost", "eq_res"),
               tuple(got[0]) + tuple(got[1:]), tuple(want[0]) + tuple(want[1:]))
    out["linearize_ok_f64_gate"] = all(
        torch.allclose(a, b, rtol=LIN_F64_RTOL, atol=LIN_F64_ATOL)
        for _, a, b in flat)
    out.update(check_mirror(ocp, cfg, Pt, x0, Z))
    for track_best in (False, True):
        solve = make_fleet_sqp_solver(
            ocp, cfg._replace(track_best=track_best), dtype=dtype, device=dev,
            backend="fused")
        res_k, res_p = solve(P, x0, Z), solve.reference(P, x0, Z)
        rel = ((res_k.z - res_p.z).abs().amax(dim=(1, 2))
               / (1.0 + res_p.z.abs().amax(dim=(1, 2))))
        key = f"sqp_fused_track_best_{int(track_best)}"
        out[key] = rel.max().item()
        out[key + "_same_success"] = bool(
            (res_k.success == res_p.success).all())
    torch.cuda.synchronize()
    return out


def check_case(build, b1: bool, device="cuda") -> dict:
    """One fleet of ``CASES`` at f64: B2's linearize entry and whole solve
    against their plain versions, and with ``b1`` B1's cold entry on the
    fleet's first QPs; relative errors and the gates' verdicts."""
    dtype = torch.float64
    cfg = matrix_config()
    ocp, *arrays = build(np.random.default_rng(0))
    P, x0, Z = (torch.as_tensor(a, dtype=dtype, device=device)
                for a in arrays)
    Pt = torch.cat([P, P[:, -1:]], dim=1)
    out = {"nx_nu": [ocp.nx, ocp.nu]}
    if b1:
        mach = _make_machinery(ocp, cfg, dtype, device)
        qp = mach.build_qp(Z, Pt, x0)
        args = (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask,
                qp.r0)
        kw = dict(nu=mach.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
                  row_meta=mach.row_meta)
        out["qp_ip"] = _rel(qp_cuda.solve_qp_batched(*args, **kw),
                            qp_cuda.ip_solve_reference(*args, **kw))
    solve = make_fleet_sqp_solver(ocp, cfg, dtype=dtype, device=device,
                                  backend="fused")
    got = sqp_fused.linearize(solve.tables, Pt, x0, Z)
    want = sqp_fused.linearize_reference(solve.machinery, solve.tables, Pt,
                                         x0, Z)
    out["linearize_ok_f64_gate"] = all(
        torch.allclose(a, b, rtol=LIN_F64_RTOL, atol=LIN_F64_ATOL)
        for a, b in zip(tuple(got[0]) + tuple(got[1:]),
                        tuple(want[0]) + tuple(want[1:])))
    res_k, res_p = solve(P, x0, Z), solve.reference(P, x0, Z)
    out["sqp_fused"] = (((res_k.z - res_p.z).abs().amax(dim=(1, 2))
                         / (1.0 + res_p.z.abs().amax(dim=(1, 2))))
                        .max().item())
    out["sqp_fused_same_success"] = bool(
        (res_k.success == res_p.success).all())
    out.update(check_mirror(ocp, cfg, Pt, x0, Z))
    torch.cuda.synchronize()
    out["ok"] = (out.get("qp_ip", 0.0) <= QP_F64_GATE
                 and out["linearize_ok_f64_gate"]
                 and all(out[f"mirror_{d}_ok_f64_gate"]
                         for d in MIRROR_DESIGNS)
                 and out["sqp_fused"] <= FUSED_F64_GATE
                 and out["sqp_fused_same_success"])
    return out


def main():
    require_card("kernel_check")
    qp_cuda.build_all()
    res = {"card": card_line(), "batch": BATCH, "f64": check(torch.float64),
           "f32": check(torch.float32),
           "cases_f64": {name: check_case(build, b1)
                         for name, (build, b1) in CASES.items()}}
    f64 = res["f64"]
    ok = (all(f64[k] <= QP_F64_GATE for k in f64 if k.startswith("qp_ip"))
          and f64["linearize_ok_f64_gate"]
          and all(f64[f"mirror_{d}_ok_f64_gate"] for d in MIRROR_DESIGNS)
          and all(f64[k] <= FUSED_F64_GATE
                  for k in ("sqp_fused_track_best_0", "sqp_fused_track_best_1"))
          and f64["sqp_fused_track_best_0_same_success"]
          and f64["sqp_fused_track_best_1_same_success"]
          and all(c["ok"] for c in res["cases_f64"].values()))
    res["ok"] = ok
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
