#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Builds both kernels from the checkout, in parallel: the interior-point QP
kernel (csrc/qp_ip.cu) and the fused whole-SQP kernel (csrc/sqp_fused.cu).
Holds each against its plain PyTorch version: the QP kernel on the bench
QPs, the fused kernel's in-kernel linearization against torch.func, and its
whole solve at f64. Solves the contouring_2obs golden at f64. Drives the
T-MPC++ fleet step (B=512 plans x 9 planners, N=20, f32) through both of the
port's paths: the main path, ``backend="fused"`` (one fused launch per
step), and the per-iteration path, ``backend="pallas"`` (one QP launch per
SQP iteration), each with the launch counts set to 0 just before it and read
just after, and holds them against each other and against the plain fused
path. Times the steps and kernels against their plain versions with CUDA
events and profiles one fused step. Any failed phase raises, so the script
exits non-zero and prints no result. The last line is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Needs one CUDA device; without one it exits with code 2.
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

BENCH_SCHEDULE = ((1, 3), (1, 5), (2, 8))
B_MAIN, N_MAIN, N_PATHS = 512, 20, 8
T0 = time.perf_counter()


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def operating_point():
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig

    return SQPConfig(n_sqp=sum(n for n, _ in BENCH_SCHEDULE),
                     n_qp_iter=BENCH_SCHEDULE[-1][1], mu_min=1e-6, w_max=1e6,
                     reg_eps=1e-4, regularization="gershgorin",
                     track_best=False, qp_iter_schedule=BENCH_SCHEDULE)


def bench_fleet(batch, dtype, device):
    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        build_tmpc_fleet, tmpc_bench_ocp)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        to_torch_fleet)

    ocp, settings = tmpc_bench_ocp(N=N_MAIN, n_paths=N_PATHS)
    arrays = build_tmpc_fleet(ocp, settings, batch, seed=0)
    return ocp, to_torch_fleet(*arrays, device=device, dtype=dtype)


def initial_qp(batch, dtype, device):
    """The bench fleet's QP batch, linearized at its initial iterate."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _f32_safe, _make_machinery)

    ocp, (params, xinit, z_init, _) = bench_fleet(batch, dtype, device)
    mach = _make_machinery(ocp, _f32_safe(operating_point(), dtype), dtype,
                           device)
    B, P = params.shape[:2]
    p = params.reshape(B * P, *params.shape[2:])
    qp = mach.build_qp(z_init.reshape(B * P, *z_init.shape[2:]),
                       torch.cat([p, p[:, -1:]], dim=1),
                       xinit.repeat_interleave(P, dim=0))
    return qp, mach


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


def cuda_time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), times


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
        qp_cuda, sqp_fused)
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
    log(f"built {len(infos)} kernel libraries in {time.perf_counter() - t:.2f} s")
    for name, info in infos.items():
        log(f"{name}: {os.path.relpath(info.path, ROOT)} (nvcc {info.seconds:.2f} s)")
        for line in info.log.splitlines():
            if "entry function" in line or "Function properties for" in line:
                log(f"ptxas {name}: {line.strip()}")
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # ---- 3. kernel against the plain version (B=64 -> 576 problems) -------
    cfg = operating_point()
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

    print(json.dumps({"kernels": [{
        "name": "qp_ip",
        "route": "cuda",
        "source": "oscar_mpc_planner_mr_modification_tpu_torch/csrc/qp_ip.cu",
        "replaces": "oscar_mpc_planner_mr_modification_tpu/ops/qp_pallas.py:136",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "sqp_fused",
        "route": "cuda",
        "source": "oscar_mpc_planner_mr_modification_tpu_torch/csrc/sqp_fused.cu",
        "replaces": "oscar_mpc_planner_mr_modification_tpu/ops/sqp_fused.py:45",
        "launches": fused_launches,
        "max_abs_err": fused_err,
        "ms": f_ms,
        "plain_ms": fp_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
