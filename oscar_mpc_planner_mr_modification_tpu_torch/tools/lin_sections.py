"""Where the mirror linearize entry (``csrc/sqp_linearize_mirror.cu``)
spends its cycles, and its time per launch, in both of its designs, at the
shapes its callers give it.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.lin_sections
    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.lin_sections \\
        --sass

Loads two builds of the entry into one process: the default one, timed by
CUDA events, and its section-counter build (``-DLIN_SECTIONS``: clock64()
cycles of problem 0's stage 0, lane 0 of its group, per section,
``csrc/tmpc_ocp.cuh`` ``LIN_SEC_*``), built into ``build/torch_kernels/``
under its own key. Cases (``CASES``): the settings-built T-MPC++ tick's 5
problems (``tools/common.py::tick_scene(..., from_settings=True)``, the
inputs dispatched at tick ``TICK_AT``), the SH-MPC OCP's 4 problems
(``tools/bench_matrix.py::build_shmpc``, seed 0, the SH-MPC tick's shape)
and the bench fleet's first 512 and all 4608 problems, each at f32 and f64.
Per case, dtype and design (one warp per problem; one block per problem, a
stage per lane group): the cycles per section, the median ms per launch,
whether the two builds give the same bits, and the largest difference from
the other design; beside them the design the batch picks, the Gershgorin
linearize entry's ms at the same inputs, the bound (``ops/roofline.py``)
and, as a yardstick for the Jacobi section alone, ``torch.linalg.eigh`` and
the product V max(|w|, eps) V^T on the same (B T, nz, nz) blocks (no
PyTorch call computes the whole entry). Then the width sweep: both designs
at the bench fleet's first ``SWEEP`` problems, f32. ``--sass`` also
compares ``cuobjdump -sass`` of the default build with that of the same
source with every counter macro line deleted. Writes the result to
``build/lin_sections.json`` (``--out``); exits with code 2 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import faulthandler
import functools
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..ops import qp_cuda, roofline, sqp_fused
from ..ops.linearize import make_lane_linearizer
from . import bench_matrix, common

#: csrc/tmpc_ocp.cuh's LIN_SEC_* ids, in order (LIN_SEC_COUNT of them).
SECTIONS = ("cost", "dyn", "rows", "jacobi", "store", "merit", "total", "n")
DESIGNS = ("warp", "block")
#: The tick whose dispatched inputs make the tick case.
TICK_AT = 12
#: Problems of the width sweep (the bench fleet's first ones).
SWEEP = (5, 9, 36, 72, 132, 264, 528, 1056, 2112, 4608)
_MACRO = re.compile(r"^\s*(if constexpr \(\w+\) )?"
                    r"LIN_(CLOCK|LAP|SKIP|INIT|FLUSH)\b.*;\s*$")


def _config():
    return common.bench_config()._replace(regularization="mirror")


def _fleet(problems, dtype):
    """The first ``problems`` problems of the bench fleet (plans of 9)."""
    plans = -(-problems // 9)
    ocp, (params, xinit, z_init, _) = common.bench_fleet(plans, dtype, "cuda")
    B, P = params.shape[:2]
    params = params.reshape(B * P, *params.shape[2:])[:problems]
    return (ocp, _config(), torch.cat([params, params[:, -1:]], dim=1),
            xinit.repeat_interleave(P, dim=0)[:problems],
            z_init.reshape(B * P, *z_init.shape[2:])[:problems])


def _tick(dtype):
    """The settings-built tick's dispatch at tick TICK_AT: (ocp, config,
    P (5, T, npar) with stage N repeating N-1, x0, Z) on the card."""
    ocp, cfg, arrays = _tick_dispatch()
    params, xinit, warm = (torch.as_tensor(a, dtype=dtype, device="cuda")
                           for a in arrays)
    P = torch.cat([params, params[:, -1:]], dim=1)
    return (ocp, cfg, P, xinit[None].expand(P.shape[0], -1).contiguous(),
            warm)


@functools.lru_cache(maxsize=None)
def _tick_dispatch():
    scene = common.tick_scene("cuda", torch.float32, from_settings=True)
    planner, opt = scene.planner, scene.optimizer
    state = scene.reset()
    planner.on_data_received(scene.build_data(state), "reference_path")
    got, dispatch = {}, opt._dispatch_batch

    def spy(params, xinit, warm):
        got["in"] = (params.copy(), np.array(xinit), warm.copy())
        return dispatch(params, xinit, warm)

    opt._dispatch_batch = spy
    for _ in range(TICK_AT):
        scene.psim.step([state.get_position()])
        out = planner.solve_mpc(state, scene.build_data(state))
        scene.advance(*scene.command(out))
    opt._dispatch_batch = dispatch
    return planner.solver.ocp, planner.solver.config, got["in"]


def _shmpc(dtype):
    ocp, *arrays = bench_matrix.build_shmpc(common.BENCH_N, 4,
                                            np.random.default_rng(0))
    P, x0, Z = (torch.as_tensor(a, dtype=dtype, device="cuda")
                for a in arrays)
    return ocp, _config(), torch.cat([P, P[:, -1:]], dim=1), x0, Z


#: name -> dtype -> (ocp, config, P, x0, Z) on the card, and the
#: operations per problem (linearization with the mirror, merit).
CASES = {
    "tick": (_tick, (roofline.TICK_LIN_MIRROR_FLOPS,
                     roofline.TICK_MERIT_FLOPS)),
    "shmpc_tick": (_shmpc, (roofline.SHMPC_LIN_MIRROR_FLOPS,
                            roofline.SHMPC_MERIT_FLOPS)),
    "bench_512": (lambda dt: _fleet(512, dt),
                  (roofline.LIN_MIRROR_FLOPS, roofline.MERIT_FLOPS)),
    "bench_4608": (lambda dt: _fleet(9 * common.BENCH_BATCH, dt),
                   (roofline.LIN_MIRROR_FLOPS, roofline.MERIT_FLOPS)),
}


def sections_library():
    """The section-counter build of the mirror entry, loaded and bound."""
    info = qp_cuda.build_all(("sqp_linearize_mirror",),
                             defines=("LIN_SECTIONS",))
    lib = sqp_fused.bind_mirror(ctypes.CDLL(info["sqp_linearize_mirror"].path))
    lib.sqp_linearize_mirror_sections.argtypes = [ctypes.c_void_p] * 2
    lib.sqp_linearize_mirror_sections.restype = ctypes.c_int
    return lib


def read_sections(lib) -> dict:
    """The counters since the last read (and zeroes them): cycles per
    launch of each section, and the launches."""
    out = torch.zeros(len(SECTIONS), dtype=torch.int64, device="cuda")
    err = lib.sqp_linearize_mirror_sections(
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sqp_linearize_mirror_sections failed ({err})")
    sec = dict(zip(SECTIONS, out.tolist()))
    n = max(sec["n"], 1)
    return {k: (v / n if k != "n" else v) for k, v in sec.items()}


def eigh_ms(H, eps, reps):
    """``torch.linalg.eigh`` and V max(|w|, eps) V^T on the blocks H
    (B T, nz, nz): ms per call, or the error where the library refuses."""
    def call():
        w, V = torch.linalg.eigh(H)
        return (V * w.abs().clamp_min(eps)[..., None, :]) @ V.mT

    try:
        return common.cuda_time_ms(call, reps=reps)[0]
    except RuntimeError as exc:
        return f"refused: {str(exc).splitlines()[0]}"


def _case(name, dtype, lib, reps) -> dict:
    make, (lin_ops, merit_ops) = CASES[name]
    ocp, cfg, P, x0, Z = make(dtype)
    lin = make_lane_linearizer(ocp, cfg, dtype=dtype, device="cuda")
    tables = lin.tables
    g_tables = sqp_fused.ocp_tables(ocp, cfg._replace(
        regularization="gershgorin"))
    raw_tables = sqp_fused.ocp_tables(ocp, cfg._replace(regularization="none"))
    ins = sqp_fused._lanes_in(P, x0, Z)
    B = Z.shape[0]
    row = dict(problems=B, T=tables.T, nz=tables.nx + tables.nu,
               dtype=str(dtype)[6:], designs={},
               picked=sqp_fused.mirror_plan(dtype, tables, B)["design"])
    outs = {}
    for design in DESIGNS:
        def launch(lib=None, design=design):
            return sqp_fused.linearize_fields(tables, *ins, mapping=design,
                                              lib=lib)

        ms, times = common.cuda_time_ms(launch, reps=reps)
        outs[design] = want = launch()
        read_sections(lib)
        got = launch(lib)
        d = dict(ms=ms, min_ms=min(times), max_ms=max(times),
                 plan=sqp_fused.mirror_plan(dtype, tables, B, design),
                 sections=read_sections(lib),
                 builds_equal=common.same_bits(got, want))
        row["designs"][design] = d
    (qa, ma), (qb, mb) = outs["warp"], outs["block"]
    row["max_abs_block_vs_warp"] = max(
        (qa - qb).abs().nan_to_num(0.0).max().item(),
        (ma - mb).abs().nan_to_num(0.0).max().item())
    row["gershgorin_ms"] = common.cuda_time_ms(
        lambda: sqp_fused.linearize_fields(g_tables, *ins), reps=reps)[0]
    H = sqp_fused.linearize(raw_tables, P, x0, Z)[0].H
    row["eigh_ms"] = eigh_ms(H.reshape(-1, *H.shape[-2:]), cfg.reg_eps, reps)
    n_out = sqp_fused.qp_layout(tables.T, tables.m, tables.mh, tables.nx,
                                tables.nu)["total"] + 3
    peak = (roofline.PEAK_FP64_FLOPS if dtype == torch.float64
            else roofline.PEAK_FP32_FLOPS)
    row["bound_ms"] = roofline.bound_ms(
        (lin_ops + merit_ops) * B,
        roofline.tensor_bytes(*ins) + Z.element_size() * B * n_out, peak)
    return row


def sweep(reps) -> dict:
    out = {}
    for problems in SWEEP:
        ocp, cfg, P, x0, Z = _fleet(problems, torch.float32)
        tables = make_lane_linearizer(ocp, cfg, dtype=torch.float32,
                                      device="cuda").tables
        ins = sqp_fused._lanes_in(P, x0, Z)
        B = Z.shape[0]
        row = dict(picked=sqp_fused.mirror_plan(torch.float32, tables,
                                                B)["design"])
        for design in DESIGNS:
            row[design] = common.cuda_time_ms(
                lambda: sqp_fused.linearize_fields(tables, *ins,
                                                   mapping=design),
                reps=reps)[0]
        out[B] = row
        print(f"sweep {B}: {json.dumps(row)}", flush=True)
    return out


def sass_check() -> dict:
    """``cuobjdump -sass`` of the default build against the same source with
    every LIN_* macro line deleted: lines, and the lines that differ (the
    kernels' ``Function :`` lines carry nvcc's anonymous-namespace tag,
    which it derives from the source text)."""
    work = os.path.join(common.ROOT, "build", "lin_sass")
    shutil.rmtree(work, ignore_errors=True)
    plain = os.path.join(work, "plain")
    shutil.copytree(qp_cuda._CSRC, plain)
    deleted = 0
    for fname in os.listdir(plain):
        path = os.path.join(plain, fname)
        with open(path) as f:
            lines = f.readlines()
        keep = [ln for ln in lines if not _MACRO.match(ln)]
        deleted += len(lines) - len(keep)
        with open(path, "w") as f:
            f.writelines(keep)
    flags = [f for f in qp_cuda._NVCC_FLAGS if f not in ("-shared",)]
    procs = {}
    for tag, src in (("default", qp_cuda._CSRC), ("plain", plain)):
        out = os.path.join(work, f"{tag}.cubin")
        procs[tag] = (subprocess.Popen(
            [qp_cuda._nvcc(), *flags, "-cubin", "-o", out,
             os.path.join(src, qp_cuda.KERNELS["sqp_linearize_mirror"])],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT), out)
    sass = {}
    dump = os.path.join(os.path.dirname(qp_cuda._nvcc()), "cuobjdump")
    for tag, (proc, out) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc -cubin ({tag}) failed")
        sass[tag] = subprocess.run([dump, "-sass", out], capture_output=True,
                                   text=True, check=True).stdout.splitlines()
    a, b = sass["default"], sass["plain"]
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return dict(macro_lines_deleted=deleted, lines=(len(a), len(b)),
                differ=len(differ) + abs(len(a) - len(b)),
                differ_not_function_lines=sum(
                    "Function :" not in a[i] for i in differ))


#: The libraries the cases run (built at once, beside the counter build).
LIBRARIES = ("qp_ip", "sqp_fused", "sqp_linearize_mirror")


def run(reps=20, sass=False) -> dict:
    result = dict(card=common.card_line(), cases={})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(sections_library)
        qp_cuda.build_all(LIBRARIES)
        lib = job.result()
    for name in CASES:
        for dtype in (torch.float32, torch.float64):
            row = _case(name, dtype, lib, reps)
            result["cases"][f"{name} {row['dtype']}"] = row
            print(f"{name}: {json.dumps(row)}", flush=True)
    result["sweep"] = sweep(reps)
    if sass:
        result["sass"] = sass_check()
        print(f"sass: {json.dumps(result['sass'])}", flush=True)
    return result


def main(argv=None) -> int:
    faulthandler.enable()
    common.require_card("lin_sections")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true",
                    help="also compare the default build's SASS with the "
                    "source without the counter macros")
    ap.add_argument("--out", default=os.path.join(common.ROOT, "build",
                                                  "lin_sections.json"))
    a = ap.parse_args(argv)
    result = run(sass=a.sass)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
