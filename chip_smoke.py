#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Builds the three kernel libraries from the checkout, in parallel, and prints
each ptxas report: the interior-point QP kernel (csrc/qp_ip.cu, with its
cold, duals/warm and field-layout entries), the fused whole-SQP kernel
(csrc/sqp_fused.cu, with its linearize entry) and the FP32 roof kernel
(csrc/fma_roof.cu). Holds each against its plain PyTorch version: the QP
kernel on the bench QPs (cold; cold with duals out, then warm from them on
the re-linearized QPs; on the linearize entry's buffer), the fused kernel's
in-kernel linearization against torch.func, its whole solve at f64, and the
roof kernel. Solves the contouring_2obs golden at f64. Drives the T-MPC++
fleet step (B=512 plans x 9 planners, N=20, f32) through each of the port's
paths, each with the launch counts set to 0 just before it and read just
after: the main path ``backend="fused"`` (one fused launch per step), the
per-iteration path ``backend="pallas"`` (one QP launch per SQP iteration),
the dual-warm per-iteration path (``n_qp_iter_warm`` 8 and 6 against cold,
at n_sqp=10, n_qp_iter=15) and the lane path ``backend="lanes"`` (one
linearize and one QP launch per SQP iteration); holds them against each
other and against the plain paths. Times the steps and kernels against their
plain versions with CUDA events, profiles the fused and lane steps, measures
the FP32 roof and the matmul ceilings (tools/bench_roofline.py) and the
achieved FLOP/s against them. Any failed phase raises, so the script exits
non-zero and prints no result. The last line is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
each with its bound. Needs one CUDA device; without one it exits with code 2.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (  # noqa: E402
    BENCH_SCHEDULE, bench_config, bench_fleet, card_line, cuda_time_ms)

B_MAIN, N_MAIN, N_PATHS = 512, 20, 8
T0 = time.perf_counter()
#: B3's kernel rounds once per step (fmaf), its plain version twice: over
#: 256 steps the two may part by up to 3 roundings of 2^-24 per step.
FMA_RTOL = 3 * 256 * 2.0 ** -24


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def bench_qps(batch, dtype, device):
    """The bench fleet's machinery and its linearization point: P (stage N
    repeating N-1), x0 and Z, flat over plans x planners."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _f32_safe, _make_machinery)

    ocp, fleet = bench_fleet(batch, dtype, device)
    mach = _make_machinery(ocp, _f32_safe(bench_config(), dtype), dtype,
                           device)
    P, x0, Z = flat_fleet(fleet)
    return mach, fleet_P(P), x0, Z


def initial_qp(batch, dtype, device):
    """The bench fleet's QP batch, linearized at its initial iterate."""
    mach, P, x0, Z = bench_qps(batch, dtype, device)
    return mach.build_qp(Z, P, x0), mach


def qp_args(qp, mach):
    return (qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e, mach.stage_mask, qp.r0)


def compare(qp, mach, n_iters, cfg):
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda

    kw = dict(nu=mach.nu, n_iters=n_iters, mu_min=cfg.mu_min, w_max=cfg.w_max,
              row_meta=mach.row_meta)
    dz_k = qp_cuda.solve_qp_batched(*qp_args(qp, mach), **kw)
    dz_p = qp_cuda.ip_solve_reference(*qp_args(qp, mach), **kw)
    torch.cuda.synchronize()
    diff = (dz_k - dz_p).abs()
    per_problem = diff.amax(dim=(1, 2)) / (1.0 + dz_p.abs().amax(dim=(1, 2)))
    return dz_k, dz_p, diff, per_problem


@contextlib.contextmanager
def plain_fused_solver(fleet_solve):
    """Route a fused fleet solver through its plain version."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused

    kernel = sqp_fused._solve_kernel
    sqp_fused._solve_kernel = (
        lambda tables, rows, config, phases, P, xinit, Z:
        sqp_fused.fused_fleet_reference(fleet_solve.machinery, config, P,
                                        xinit, Z))
    try:
        yield
    finally:
        sqp_fused._solve_kernel = kernel


def flat_fleet(args):
    """Fleet step inputs (B, P, ...) -> fleet solve inputs (B*P, ...)."""
    params, xinit, z_init, _ = args
    B, P = params.shape[:2]
    return (params.reshape(B * P, *params.shape[2:]),
            xinit.repeat_interleave(P, dim=0),
            z_init.reshape(B * P, *z_init.shape[2:]))


def fleet_P(params):
    """(B*P, N, npar) -> (B*P, N+1, npar), stage N repeating N-1."""
    return torch.cat([params, params[:, -1:]], dim=1)


def profile_step(step, args):
    """Device kernels, device busy ms (union of device intervals) and wall ms
    of one step under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy / 1e3, wall


@contextlib.contextmanager
def plain_qp_solver():
    """Route the SQP engine's QP solves through the plain version."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda

    kernel = qp_cuda.solve_qp_batched
    qp_cuda.solve_qp_batched = qp_cuda.ip_solve_reference
    try:
        yield
    finally:
        qp_cuda.solve_qp_batched = kernel


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"ok: {msg}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from oscar_mpc_planner_mr_modification_tpu_torch.ops import (
        qp_cuda, roofline, sqp_fused)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        QPData, SQPConfig, make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        make_batched_tmpc_step)

    # ---- 1. environment -------------------------------------------------
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([qp_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- 2. build (one nvcc per kernel source, all started together) ------
    t = time.perf_counter()
    infos = qp_cuda.build_all()
    qp_cuda._library()
    sqp_fused._library()
    roofline._library()
    log(f"built {len(infos)} kernel libraries in {time.perf_counter() - t:.2f} s")
    for name, info in infos.items():
        log(f"{name}: {os.path.relpath(info.path, ROOT)} (nvcc {info.seconds:.2f} s)")
        for line in info.log.splitlines():
            if "entry function" in line or "Function properties for" in line:
                log(f"ptxas {name}: {line.strip()}")
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # ---- 3. kernel against the plain version (B=64 -> 576 problems) -------
    cfg = bench_config()
    qp64, mach64 = initial_qp(64, torch.float64, dev)
    _, dz64, diff, _ = compare(qp64, mach64, 8, cfg)
    scale = 1.0 + dz64.abs().max().item()
    log(f"f64 576 problems: max|dz| {dz64.abs().max().item():.6e}, "
        f"max|ddz| {diff.max().item():.6e}, median |ddz| "
        f"{diff.median().item():.6e}")
    check(diff.max().item() <= 1e-8 * scale,
          f"f64 kernel = plain: max|ddz| <= 1e-8 (1 + max|dz|) = {1e-8 * scale:.3e}")

    qp32, mach32 = initial_qp(64, torch.float32, dev)
    dz_k, dz_p, diff, rel = compare(qp32, mach32, 8, cfg)
    log(f"f32 576 problems: max|ddz| {diff.max().item():.6e}, median |ddz| "
        f"{diff.median().item():.6e}, median rel {rel.median().item():.6e}")
    check(rel.median().item() <= 1e-4,
          "f32 kernel = plain: median over problems of max|ddz| / (1 + max|dz|) <= 1e-4")
    check(bool(torch.isfinite(dz_k)[torch.isfinite(dz_p)].all()),
          "f32 kernel dz finite wherever the plain dz is")
    # Where the two f32 solves part, both part from the f64 solution: solve
    # the f64 QPs rounded to f32 both ways and hold each against it.
    qp_r = type(qp64)(*(x.float() for x in qp64))
    dz_k, dz_p, _, _ = compare(qp_r, mach64, 8, cfg)
    for name, dz in (("kernel", dz_k), ("plain", dz_p)):
        err = (dz.double() - dz64).abs().amax(dim=(1, 2))
        log(f"f32 {name} vs f64 solution on the rounded QPs: max "
            f"{err.max().item():.6e}, p99 {err.quantile(0.99).item():.6e}, "
            f"median {err.median().item():.6e}")

    # ---- 4. f64 golden: contouring_2obs ----------------------------------
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    gold = np.load(os.path.join(ROOT, "tests", "golden", "contouring_2obs.npz"))
    settings = default_settings(N=15, max_obstacles=2)
    ocp_g = build_ocp(*configuration_basic(settings), settings)
    check(ocp_g.npar == 69, f"configuration_basic npar = {ocp_g.npar} == 69")
    solve_g = make_fleet_sqp_solver(
        ocp_g, SQPConfig(n_sqp=30, n_qp_iter=20, mu_min=1e-10,
                         regularization="mirror", track_best=True),
        dtype=torch.float64, device=dev)
    n0 = qp_cuda.launches
    res_g = solve_g(gold["P"][None], gold["x0"][None], gold["z_init"][None])
    torch.cuda.synchronize()
    zerr = float(np.abs(res_g.z[0].cpu().numpy() - gold["Z"]).max())
    cost_g = float(res_g.cost[0])
    log(f"golden: max|Z - Z_gold| {zerr:.6e}, cost {cost_g:.12f} vs "
        f"{float(gold['cost']):.12f}, eq_res {float(res_g.eq_res[0]):.3e}, "
        f"kernel launches {qp_cuda.launches - n0}")
    check(qp_cuda.launches - n0 == 30, "golden solve ran 30 kernel launches")
    check(bool(res_g.success[0]), "golden solve succeeded")
    check(zerr <= 1e-4, "golden Z within atol 1e-4")
    check(abs(cost_g - float(gold["cost"])) <= 1e-5 * abs(float(gold["cost"])),
          "golden cost within rtol 1e-5")

    # ---- 5. fused kernel: in-kernel linearization vs torch.func (576) -----
    lin_err = 0.0
    for dtype in (torch.float64, torch.float32):
        ocp64, args64 = bench_fleet(64, dtype, dev)
        fused64 = make_fleet_sqp_solver(ocp64, cfg, dtype=dtype, device=dev,
                                        backend="fused")
        P64, x64, z64 = flat_fleet(args64)
        lin_args = (fleet_P(P64), x64, z64)
        got = sqp_fused.linearize(fused64.tables, *lin_args)
        want = sqp_fused.linearize_reference(fused64.machinery, fused64.tables,
                                             *lin_args)
        torch.cuda.synchronize()
        names = QPData._fields + ("merit", "cost", "eq_res")
        flat_got = tuple(got[0]) + tuple(got[1:])
        flat_want = tuple(want[0]) + tuple(want[1:])
        worst = []
        for name, a, b in zip(names, flat_got, flat_want):
            rel = (a - b).abs() / (1.0 + b.abs())
            if dtype == torch.float64:
                lin_err = max(lin_err, (a - b).abs().max().item())
            log(f"{str(dtype)[6:]} linearize {name}: max|d| "
                f"{(a - b).abs().max().item():.3e}, median |d|/(1+|ref|) "
                f"{rel.median().item():.3e}, max|ref| {b.abs().max().item():.3e}")
            if dtype == torch.float64:
                if not torch.allclose(a, b, rtol=1e-9, atol=1e-10):
                    worst.append(name)
            elif rel.median().item() > 1e-4:
                worst.append(name)
        if dtype == torch.float64:
            check(not worst, "f64 in-kernel linearization = build_qp on every "
                  f"field within rtol 1e-9, atol 1e-10 (failed: {worst})")
        else:
            check(not worst, "f32 in-kernel linearization = build_qp: median "
                  f"|d|/(1+|ref|) <= 1e-4 on every field (failed: {worst})")

    # ---- 6. fused kernel vs its plain version at f64 (576 problems) ------
    ocp64, args64 = bench_fleet(64, torch.float64, dev)
    fused_err = 0.0
    for track_best in (False, True):
        fused64 = make_fleet_sqp_solver(
            ocp64, cfg._replace(track_best=track_best), dtype=torch.float64,
            device=dev, backend="fused")
        res_k = fused64(*flat_fleet(args64))
        res_p = fused64.reference(*flat_fleet(args64))
        torch.cuda.synchronize()
        diff = (res_k.z - res_p.z).abs()
        rel = diff.amax(dim=(1, 2)) / (1.0 + res_p.z.abs().amax(dim=(1, 2)))
        fused_err = max(fused_err, diff.max().item())
        log(f"f64 fused solve, track_best={track_best}: success "
            f"{res_k.success.float().mean().item():.6f} (plain "
            f"{res_p.success.float().mean().item():.6f}), max|dZ| "
            f"{diff.max().item():.3e}, max rel {rel.max().item():.3e}, "
            f"max|dcost| {(res_k.cost - res_p.cost).abs().max().item():.3e}")
        check(bool((res_k.success == res_p.success).all()),
              f"f64 fused kernel success mask = plain (track_best={track_best})")
        check(rel.max().item() <= 1e-6,
              "f64 fused kernel = plain: per problem max|dZ| / (1 + max|Z|) "
              "<= 1e-6")

    # ---- 7. main path at full width: backend="fused" ----------------------
    ocp, args = bench_fleet(B_MAIN, torch.float32, dev)
    step = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32, device=dev,
                                  backend="fused")
    qp_cuda.launches = sqp_fused.launches = 0
    out = step(*args)
    torch.cuda.synchronize()
    fused_launches, b1_in_fused = sqp_fused.launches, qp_cuda.launches
    check(fused_launches == 1 and b1_in_fused == 0,
          f"fused fleet step: {fused_launches} fused launch(es) (want 1), "
          f"{b1_in_fused} QP-kernel launches (want 0)")
    P = N_PATHS + 1
    check(tuple(out.best_z.shape) == (B_MAIN, N_MAIN + 1, ocp.nvar)
          and bool(torch.isfinite(out.best_z).all()),
          f"best_z finite, shape {tuple(out.best_z.shape)}")
    success_rate = out.any_success.float().mean().item()
    per_planner = out.all_success.float().mean(dim=0).cpu().numpy()
    log(f"fused step: success_rate (best-of-{P}) {success_rate:.6f}; per "
        f"planner {np.array2string(per_planner, precision=4)}; mean "
        f"{per_planner.mean():.6f}")
    check(success_rate >= 0.95, "fused step: best-of-9 success_rate >= 0.95")

    def agreement(other, name):
        agree = (out.any_success == other.any_success).float().mean().item()
        both = out.any_success & other.any_success
        rel_cost = ((out.best_cost - other.best_cost).abs()
                    / other.best_cost.abs().clamp(min=1e-12))[both]
        log(f"{name}: success_rate "
            f"{other.any_success.float().mean().item():.6f}, any_success "
            f"agreement with the fused step {agree:.6f}, median rel best_cost "
            f"diff {rel_cost.median().item():.6e}")
        check(agree >= 0.99,
              f"fused step any_success agrees with the {name} on >= 99% of plans")

    with plain_fused_solver(step.fleet_solve):
        n0 = sqp_fused.launches + qp_cuda.launches
        out_pf = step(*args)
        torch.cuda.synchronize()
        check(sqp_fused.launches + qp_cuda.launches == n0,
              "plain fused step launched no kernel")
    agreement(out_pf, "plain fused step")

    # ---- 8. the per-iteration path at full width: backend="pallas" -------
    step_b1 = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32, device=dev,
                                     backend="pallas")
    qp_cuda.launches = sqp_fused.launches = 0
    out_b1 = step_b1(*args)
    torch.cuda.synchronize()
    main_launches = qp_cuda.launches
    n_sqp = sum(n for n, _ in BENCH_SCHEDULE)
    check(main_launches == n_sqp and sqp_fused.launches == 0,
          f"per-iteration fleet step launched the QP kernel {main_launches} "
          f"times (one per SQP iteration, {n_sqp}) and the fused kernel "
          f"{sqp_fused.launches} times (want 0)")
    b1_success = out_b1.any_success.float().mean().item()
    check(b1_success >= 0.95, "per-iteration step: best-of-9 success_rate >= 0.95")
    agreement(out_b1, "per-iteration (QP kernel) step")
    with plain_qp_solver():
        n0 = qp_cuda.launches
        out_p = step_b1(*args)
        torch.cuda.synchronize()
        check(qp_cuda.launches == n0, "plain per-iteration step launched no kernel")
    agree = (out_b1.any_success == out_p.any_success).float().mean().item()
    log(f"plain per-iteration step: any_success agreement with the "
        f"per-iteration step {agree:.6f}")
    check(agree >= 0.99, "per-iteration step any_success agrees with its plain "
          "step on >= 99% of plans")

    # ---- 9. times ----------------------------------------------------------
    step_ms, _ = cuda_time_ms(lambda: step(*args), reps=10)
    b1_step_ms, _ = cuda_time_ms(lambda: step_b1(*args), reps=5, warmup=1)
    with plain_fused_solver(step.fleet_solve):
        plain_fused_ms, _ = cuda_time_ms(lambda: step(*args), reps=3, warmup=0)
    with plain_qp_solver():
        plain_step_ms, _ = cuda_time_ms(lambda: step_b1(*args), reps=3,
                                        warmup=0)
    log(f"[{card}] fleet step (B={B_MAIN} x {P} planners, N={N_MAIN}, f32), "
        f"median of 10 / 5 / 3 / 3: fused kernel path {step_ms:.3f} ms = "
        f"{B_MAIN / step_ms * 1e3:.1f} plans/s; per-iteration (QP kernel) "
        f"path {b1_step_ms:.3f} ms = {B_MAIN / b1_step_ms * 1e3:.1f} plans/s; "
        f"plain fused path {plain_fused_ms:.3f} ms = "
        f"{B_MAIN / plain_fused_ms * 1e3:.1f} plans/s; plain per-iteration "
        f"path {plain_step_ms:.3f} ms = {B_MAIN / plain_step_ms * 1e3:.1f} "
        f"plans/s")
    flat = flat_fleet(args)
    f_ms, f_all = cuda_time_ms(lambda: step.fleet_solve(*flat), reps=10)
    fp_ms, _ = cuda_time_ms(lambda: step.fleet_solve.reference(*flat), reps=3,
                            warmup=0)
    log(f"[{card}] fused solve at the bench shape ({B_MAIN * P} problems, "
        f"T={N_MAIN + 1}, schedule {BENCH_SCHEDULE}, f32): kernel {f_ms:.3f} "
        f"ms per launch (min {min(f_all):.3f}, median of 10), plain "
        f"fused_fleet_reference {fp_ms:.3f} ms (median of 3)")
    lin_in = (fleet_P(flat[0]), flat[1], flat[2])
    l_ms, _ = cuda_time_ms(
        lambda: sqp_fused.linearize(step.fleet_solve.tables, *lin_in), reps=10)
    log(f"[{card}] fused kernel's linearization alone (sqp_fused_linearize "
        f"entry plus unpacking) at the bench shape, f32: {l_ms:.3f} ms per "
        f"call (median of 10)")
    n_dev, busy_ms, wall_ms = profile_step(step, args)
    log(f"[{card}] torch.profiler, one fused step: {n_dev} device ops, device "
        f"busy {busy_ms:.3f} ms, profiled wall {wall_ms:.3f} ms; idle share "
        f"{1 - busy_ms / wall_ms:.4f} (profiled), "
        f"{1 - busy_ms / step_ms:.4f} (against the unprofiled step)")

    qpb, machb = initial_qp(B_MAIN, torch.float32, dev)
    dz_k, dz_p, diff, rel = compare(qpb, machb, 8, cfg)
    max_abs_err = diff.max().item()
    log(f"bench-shape QP ({qpb.H.shape[0]} problems, T={qpb.H.shape[1]}, "
        f"m={qpb.D.shape[2]}, 8 iterations, f32): max|ddz| {max_abs_err:.6e}, "
        f"median rel {rel.median().item():.6e}")
    check(rel.median().item() <= 1e-4, "bench-shape f32 kernel = plain (median rel <= 1e-4)")
    kw = dict(nu=machb.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
              row_meta=machb.row_meta)
    k_ms, k_all = cuda_time_ms(
        lambda: qp_cuda.solve_qp_batched(*qp_args(qpb, machb), **kw), reps=20)
    p_ms, _ = cuda_time_ms(
        lambda: qp_cuda.ip_solve_reference(*qp_args(qpb, machb), **kw), reps=5)
    log(f"[{card}] IP solve per launch at the bench shape: kernel {k_ms:.3f} ms "
        f"(min {min(k_all):.3f}), plain {p_ms:.3f} ms")
    z0 = args[2].reshape(B_MAIN * P, *args[2].shape[2:])
    p0 = args[0].reshape(B_MAIN * P, *args[0].shape[2:])
    p0 = torch.cat([p0, p0[:, -1:]], dim=1)
    x0 = args[1].repeat_interleave(P, dim=0)
    lin_ms, _ = cuda_time_ms(lambda: machb.build_qp(z0, p0, x0), reps=5)
    log(f"[{card}] linearization (build_qp, torch.func) per SQP iteration at "
        f"the bench shape: {lin_ms:.3f} ms")

    n_problems = B_MAIN * P
    tables = step.fleet_solve.tables
    lin_f = sqp_fused._lanes_in(*lin_in)
    lf_ms, _ = cuda_time_ms(
        lambda: sqp_fused.linearize_fields(tables, *lin_f), reps=10)
    lr_ms, _ = cuda_time_ms(
        lambda: sqp_fused.linearize_reference(step.fleet_solve.machinery,
                                              tables, *lin_in), reps=3,
        warmup=1)
    log(f"[{card}] linearize entry alone (sqp_fused_linearize, field-major "
        f"in and out, no unpacking) at the bench shape, f32: {lf_ms:.3f} ms "
        f"per launch; plain linearize_reference {lr_ms:.3f} ms")

    # ---- 10. B1's dual variants vs the plain version at the bench QPs -----
    def gap(a, b):
        """|a - b|, 0 where both are NaN (a NaN on one side stays NaN)."""
        return torch.where(torch.isnan(a) & torch.isnan(b),
                           torch.zeros_like(a), (a - b).abs())

    def duals_pair(qp, mach, n_iters, lam0=None):
        kw = dict(nu=mach.nu, n_iters=n_iters, mu_min=cfg.mu_min,
                  w_max=cfg.w_max, row_meta=mach.row_meta, lam0=lam0)
        got = qp_cuda.solve_qp_batched_duals(*qp_args(qp, mach), **kw)
        want = qp_cuda.ip_solve_reference(*qp_args(qp, mach), duals_out=True,
                                          **kw)
        torch.cuda.synchronize()
        return got, want

    duals_err = 0.0
    for dtype, batch in ((torch.float64, 64), (torch.float32, B_MAIN)):
        mach_d, P_d, x_d, Z_d = bench_qps(batch, dtype, dev)
        cold = duals_pair(mach_d.build_qp(Z_d, P_d, x_d), mach_d, 8)
        dz_d, lam_d = cold[0]
        # The warm start: the QPs re-linearized after the kernel's step, warm
        # from its multipliers (NaN reseeded to 1, as the fleet path does).
        lam_1 = torch.where(torch.isnan(lam_d), torch.ones_like(lam_d), lam_d)
        qp_1 = mach_d.build_qp(Z_d + torch.nan_to_num(dz_d), P_d, x_d)
        warm = duals_pair(qp_1, mach_d, 6, lam0=lam_1)
        for phase, (got, want) in (("cold", cold), ("warm", warm)):
            for name, a, b in zip(("z", "lam"), got, want):
                d = gap(a, b)
                ref = torch.nan_to_num(b).abs()
                rel = d.flatten(1).amax(1) / (1.0 + ref.flatten(1).amax(1))
                scale = 1.0 + ref.max().item()
                log(f"{str(dtype)[6:]} duals {phase} ({a.shape[0]} problems): "
                    f"{name} max|d| {d.max().item():.3e}, max|ref| "
                    f"{scale - 1:.3e}, median rel {rel.median().item():.3e}, "
                    f"NaN {int(torch.isnan(b).sum())}")
                if dtype == torch.float64:
                    check(d.max().item() <= 1e-8 * scale,
                          f"f64 duals kernel = plain ({phase}, {name}): max|d|"
                          f" <= 1e-8 (1 + max|ref|) = {1e-8 * scale:.3e}")
                else:
                    check(rel.median().item() <= 1e-4,
                          f"f32 duals kernel = plain ({phase}, {name}): median"
                          f" over problems of max|d| / (1 + max|ref|) <= 1e-4")
                    if name == "z":
                        duals_err = max(duals_err, d.max().item())
    kw_w = dict(nu=mach_d.nu, n_iters=8, mu_min=cfg.mu_min, w_max=cfg.w_max,
                row_meta=mach_d.row_meta, lam0=lam_1)
    dk_ms, dk_all = cuda_time_ms(lambda: qp_cuda.solve_qp_batched_duals(
        *qp_args(qp_1, mach_d), **kw_w), reps=20)
    dp_ms, _ = cuda_time_ms(lambda: qp_cuda.ip_solve_reference(
        *qp_args(qp_1, mach_d), duals_out=True, **kw_w), reps=5)
    log(f"[{card}] duals/warm IP solve per launch at the bench shape (warm, 8 "
        f"iterations, f32): kernel {dk_ms:.3f} ms (min {min(dk_all):.3f}), "
        f"plain {dp_ms:.3f} ms")

    # ---- 11. path (a): the dual-warm per-iteration fleet step -------------
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_roofline, bench_warm)

    def reset_counts():
        qp_cuda.launches = qp_cuda.duals_launches = qp_cuda.warm_launches = 0
        qp_cuda.lanes_launches = sqp_fused.launches = 0
        sqp_fused.linearize_launches = sqp_fused.merit_launches = 0
        roofline.launches = 0

    def counts():
        return dict(qp_ip=qp_cuda.launches, duals=qp_cuda.duals_launches,
                    warm=qp_cuda.warm_launches, lanes=qp_cuda.lanes_launches,
                    sqp_fused=sqp_fused.launches,
                    linearize=sqp_fused.linearize_launches,
                    merit=sqp_fused.merit_launches)

    none = dict.fromkeys(counts(), 0)
    n_sqp_w = bench_warm.BASE.n_sqp
    warm_ref, warm_ms = None, {}
    for name, wcfg in bench_warm.VARIANTS:
        wstep = make_batched_tmpc_step(ocp, wcfg, dtype=torch.float32,
                                       device=dev, backend="pallas")
        reset_counts()
        wout = wstep(*args)
        torch.cuda.synchronize()
        got = counts()
        want = ({**none, "duals": n_sqp_w, "warm": n_sqp_w - 1}
                if wcfg.n_qp_iter_warm else {**none, "qp_ip": n_sqp_w})
        check(got == want, f"{name} step (n_sqp={n_sqp_w}, n_qp_iter="
              f"{wcfg.n_qp_iter}, n_qp_iter_warm={wcfg.n_qp_iter_warm}) "
              f"launches {got} (want {want})")
        if name == "warm8":
            warm_launches = got["duals"]
        summ = bench_warm.summary(wout)
        warm_ms[name], _ = cuda_time_ms(lambda: wstep(*args), reps=2,
                                        warmup=0)
        log(f"[{card}] {name} step: {warm_ms[name]:.3f} ms (median of 2) = "
            f"{B_MAIN / warm_ms[name] * 1e3:.1f} plans/s; success (best-of-"
            f"{P}) {summ['success']:.6f}, per problem "
            f"{summ['success_per_problem']:.6f}")
        check(summ["success"] >= 0.95, f"{name} step: best-of-9 success >= 0.95")
        if warm_ref is None:
            warm_ref = wout
            continue
        vs = bench_warm.against(wout, warm_ref)
        log(f"{name} vs cold: any_success agreement {vs['agreement']:.6f}; "
            f"cost_rel_p99 (per problem both solved, the JAX tool's metric) "
            f"{vs['cost_rel_p99']:.6e}; best_cost_rel_p99 (per plan both "
            f"solved, on the best cost) {vs['best_cost_rel_p99']:.6e}")
        check(vs["agreement"] >= 0.99,
              f"{name} step any_success agrees with the cold step on >= 99%")

    # ---- 12. path (b): the lane fleet step, backend="lanes" ---------------
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.linearize import (
        make_lane_linearizer)

    step_ln = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32, device=dev,
                                     backend="lanes")
    mach_ln = step_ln.fleet_solve.machinery
    func_calls = {"build_qp": 0, "merit_of": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            func_calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in func_calls:
        setattr(mach_ln, name, counted(name, getattr(mach_ln, name)))
    reset_counts()
    out_ln = step_ln(*args)
    torch.cuda.synchronize()
    got = counts()
    n_it = sum(n for n, _ in BENCH_SCHEDULE)
    want = {**none, "lanes": n_it, "linearize": n_it, "merit": 1}
    check(got == want and not any(func_calls.values()),
          f"lane step launches {got} (want {want}: a linearize and a QP "
          f"launch per SQP iteration, one merit launch at the end), "
          f"torch.func calls {func_calls} (want none)")
    lanes_launches = got["lanes"]
    lanlin_launches = got["linearize"] + got["merit"]
    ln_success = out_ln.any_success.float().mean().item()
    check(ln_success >= 0.95, "lane step: best-of-9 success_rate >= 0.95")
    agreement(out_ln, "lane step")
    ln_ms, ln_all = cuda_time_ms(lambda: step_ln(*args), reps=10)
    n_dev, busy_ms, wall_ms = profile_step(step_ln, args)
    log(f"[{card}] lane step: {ln_ms:.3f} ms (median of 10, min "
        f"{min(ln_all):.3f}) = {B_MAIN / ln_ms * 1e3:.1f} plans/s; "
        f"torch.profiler, one step: {n_dev} device ops, device busy "
        f"{busy_ms:.3f} ms, profiled wall {wall_ms:.3f} ms; idle share "
        f"{1 - busy_ms / wall_ms:.4f} (profiled), "
        f"{1 - busy_ms / ln_ms:.4f} (against the unprofiled step)")

    lanes_err = 0.0
    for dtype, batch in ((torch.float64, 64), (torch.float32, B_MAIN)):
        ocp_l, fleet_l = bench_fleet(batch, dtype, dev)
        lin = make_lane_linearizer(ocp_l, cfg, dtype=dtype, device=dev)
        P_l, x_l, Z_l = flat_fleet(fleet_l)
        fields, _ = lin.fields(fleet_P(P_l).permute(2, 1, 0).contiguous(),
                               Z_l.permute(1, 2, 0).contiguous(),
                               x_l.t().contiguous())
        kw_l = dict(nu=lin.machinery.nu, n_iters=8, mu_min=cfg.mu_min,
                    w_max=cfg.w_max, row_meta=lin.machinery.row_meta)
        mask_l = lin.machinery.stage_mask
        zk = qp_cuda.solve_qp_fields(fields, mask_l, **kw_l)
        zp = qp_cuda.fields_reference(fields, mask_l, **kw_l)
        torch.cuda.synchronize()
        d = gap(zk, zp)
        ref = torch.nan_to_num(zp).abs()
        rel = d.amax(0) / (1.0 + ref.amax(0))
        scale = 1.0 + ref.max().item()
        log(f"{str(dtype)[6:]} lane QP entry on the linearize buffer "
            f"({zk.shape[1]} problems, 8 iterations): max|d| "
            f"{d.max().item():.3e}, median rel {rel.median().item():.3e}")
        if dtype == torch.float64:
            check(d.max().item() <= 1e-8 * scale,
                  f"f64 lane QP kernel = plain: max|d| <= 1e-8 (1 + max|ref|)"
                  f" = {1e-8 * scale:.3e}")
        else:
            check(rel.median().item() <= 1e-4,
                  "f32 lane QP kernel = plain: median rel <= 1e-4")
            lanes_err = d.max().item()
    lk_ms, lk_all = cuda_time_ms(
        lambda: qp_cuda.solve_qp_fields(fields, mask_l, **kw_l), reps=20)
    lp_ms, _ = cuda_time_ms(
        lambda: qp_cuda.fields_reference(fields, mask_l, **kw_l), reps=5)
    log(f"[{card}] lane QP entry per launch at the bench shape (8 iterations, "
        f"f32): kernel {lk_ms:.3f} ms (min {min(lk_all):.3f}), plain "
        f"{lp_ms:.3f} ms")

    # ---- 13. path (c): kernel B3, the FP32 roof, achieved FLOP/s ----------
    gen = torch.Generator(device=dev).manual_seed(0)
    x_r = torch.randn(bench_roofline.ROOF_SHAPES[0][0], device=dev,
                      generator=gen)
    y_k = roofline.fma_roof(x_r)
    y_p = roofline.fma_roof_reference(x_r)
    y_e = roofline.fma_roof_emulated(x_r)
    torch.cuda.synchronize()
    fma_err = (y_k - y_p).abs().max().item()
    ulp = (torch.nextafter(y_e, torch.full_like(y_e, float("inf"))) - y_e).abs()
    ulps = ((y_k.double() - y_e.double()).abs() / ulp.double()).max().item()
    same = (y_k == y_e).float().mean().item()
    log(f"B3 at {tuple(x_r.shape)} f32: kernel vs plain max|d| {fma_err:.3e}, "
        f"max rel {((y_k - y_p).abs() / y_p.abs()).max().item():.3e}; vs the "
        f"emulated fmaf recurrence (f64 steps, one rounding to f32 each): "
        f"max {ulps:.3f} ULP, bit-equal share {same:.6f}")
    check(ulps <= 1.0 and same >= 0.999,
          "B3 kernel = emulated fmaf recurrence within 1 ULP, bit-equal on "
          ">= 99.9% of elements (one missing step moves most elements by "
          ">= 2 ULP)")
    check(torch.allclose(y_k, y_p, rtol=FMA_RTOL, atol=1e-6),
          f"B3 kernel = plain within rtol {FMA_RTOL:.3e} (3 roundings of "
          f"2^-24 per step over 256 steps), atol 1e-6")
    fk_ms, _ = cuda_time_ms(lambda: roofline.fma_roof(x_r), reps=10,
                            inner=100)
    fpl_ms, _ = cuda_time_ms(lambda: roofline.fma_roof_reference(x_r), reps=5)
    reset_counts()
    roof = bench_roofline.roof()
    roof_launches = roofline.launches
    check(roof_launches > 0 and counts() == none,
          f"roof measurement launched B3 {roof_launches} times and no other "
          f"kernel ({counts()})")
    mm32 = bench_roofline.matmul_rate(torch.float32)
    mm16 = bench_roofline.matmul_rate(torch.bfloat16)
    peak = roofline.PEAK_FP32_FLOPS / 1e12
    for r in roof["sizes"]:
        log(f"[{card}] B3 roof at {tuple(r['shape'])}: {r['ms']:.6f} ms per "
            f"launch, {r['tflops']:.3f} TFLOP/s ({r['tflops'] / peak:.4f} of "
            f"the published {peak:.0f})")
    log(f"[{card}] measured FP32 roof {roof['tflops']:.3f} TFLOP/s; chained "
        f"2048^3 torch.matmul: f32 (TF32 off) {mm32:.3f} TFLOP/s, bf16 "
        f"{mm16:.3f} TFLOP/s; B3 plain version {fpl_ms:.3f} ms at "
        f"{tuple(x_r.shape)} against {fk_ms:.6f} ms")
    for name, ms in (("fused step", step_ms), ("per-iteration step",
                                               b1_step_ms),
                     ("lane step", ln_ms)):
        a = bench_roofline.achieved(ms, n_problems, roof["tflops"])
        log(f"[{card}] {name} achieved: {a['algo_tflops']:.4f} TFLOP/s by the "
            f"JAX bench's count ({a['algo_share_of_roof']:.5f} of the roof, "
            f"{a['algo_share_of_peak']:.5f} of {peak:.0f}); "
            f"{a['full_tflops']:.4f} TFLOP/s by the full count "
            f"({a['full_share_of_roof']:.5f} of the roof)")
    for name, flops, ms in (
            ("B1 (8 IP iterations)", roofline.ip_flops(n_problems, 8), k_ms),
            ("B2 (the whole solve)",
             roofline.sqp_flops(n_problems, BENCH_SCHEDULE), f_ms)):
        tf = flops / ms / 1e9
        log(f"[{card}] {name} achieved {tf:.4f} TFLOP/s = "
            f"{tf / roof['tflops']:.5f} of the measured roof, "
            f"{tf / peak:.5f} of {peak:.0f} TFLOP/s")

    # ---- the kernels, each with its bound ---------------------------------
    def entry(name, source, replaces, launches, err, ms, plain_ms, flops,
              n_bytes):
        bound, by = roofline.bound_ms(flops, n_bytes)
        return {"name": name, "route": "cuda",
                "source": f"oscar_mpc_planner_mr_modification_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}

    jax_ops = "oscar_mpc_planner_mr_modification_tpu/ops"
    T_b, nx_b, m_b = N_MAIN + 1, qpb.A.shape[-1], qpb.D.shape[2]
    qp_b = roofline.qp_bytes(T_b, nx_b, machb.nu, m_b, tables.mh, n_problems,
                             4)
    ip_it = roofline.ip_iter_flops(machb.row_meta, machb.stage_mask, nx_b,
                                   machb.nu)
    check(ip_it == roofline.IP_ITER_FLOPS,
          f"IP iteration count at this run's rows and mask {ip_it} = "
          f"IP_ITER_FLOPS {roofline.IP_ITER_FLOPS}")
    ip8 = roofline.ip_flops(n_problems, 8)
    lin_b = roofline.tensor_bytes(*lin_in) + 4 * n_problems * (
        sqp_fused.qp_layout(T_b, m_b, tables.mh)["total"] + 3)
    print(json.dumps({"kernels": [
        entry("qp_ip", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:136",
              main_launches, max_abs_err, k_ms, p_ms, ip8, qp_b),
        entry("qp_ip_duals", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:757",
              warm_launches, duals_err, dk_ms, dp_ms, ip8,
              roofline.qp_bytes(T_b, nx_b, machb.nu, m_b, tables.mh,
                                n_problems, 4, lam_in=True, lam_out=True)),
        entry("qp_ip_lanes", "qp_ip.cu", f"{jax_ops}/qp_pallas.py:794",
              lanes_launches, lanes_err, lk_ms, lp_ms, ip8, qp_b),
        entry("sqp_fused", "sqp_fused.cu", f"{jax_ops}/sqp_fused.py:45",
              fused_launches, fused_err, f_ms, fp_ms,
              roofline.sqp_flops(n_problems, BENCH_SCHEDULE),
              roofline.tensor_bytes(*lin_in, flat[2]) + 8 * n_problems),
        entry("sqp_fused_linearize", "sqp_fused.cu",
              f"{jax_ops}/sqp_fused.py:45", lanlin_launches, lin_err, lf_ms,
              lr_ms, roofline.LIN_FLOPS * n_problems, lin_b),
        entry("fma_roof", "fma_roof.cu", "tools/bench_roofline.py:85",
              roof_launches, fma_err, fk_ms, fpl_ms,
              roofline.fma_flops(x_r.numel()), 8 * x_r.numel()),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
