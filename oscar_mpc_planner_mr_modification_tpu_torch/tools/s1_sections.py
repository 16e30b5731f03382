"""Where the single-instance kernel S1 (``csrc/sqp_single.cu``) spends its
cycles, and its time per launch, at the shapes its callers give it.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.s1_sections
    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.s1_sections --times

Builds S1 with its section counters (``-DS1_SECTIONS``: clock64() cycles of
problem 0's thread 0 per section, ``csrc/sqp_single.cuh`` ``SEC_*``) into
``build/torch_kernels/`` under its own key and runs it on the cases of
``CASES``: the contouring_2obs golden (T=16, f64, 30 x 20), the
configuration_basic tick's problem (BASELINE config 2,
``tools/common.py::basic_problem``, T=31, f64, 10 x 18), the fleet-process
demo robot (``goal_demo_problem(10)``, T=11, f64, 4 x 8), the ``"xla"``
fleet step's 72 problems (the bench's small batch, T=21, f32, its
schedule) and the bench fleet's 4608 problems through the same step.
Prints, per case, the cycles per interior-point iteration of each section
of the QP solve, the cycles per SQP iteration of the linearization, the
mirror pass, the merits and the step, the launch plan and the median ms
per launch of the default build (CUDA events), and whether the two builds
give the same bits. The two builds are loaded into one process. Then it
times the default build at the ``"xla"`` step's batches of
``SWEEP_PLANS`` plans (where S1's block width follows the batch).
``--times`` times the default build alone (the cases and the sweep) and
needs only what S1's wrapper has had since it was written, so that the
file, copied into an older checkout, times that checkout's S1. Writes the
result to ``build/s1_sections.json`` (``--out``); exits with code 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import json
import os
import sys

import numpy as np
import torch

from ..ops import qp_cuda, sqp_single
from ..ops.sqp import SQPConfig
from . import common

#: csrc/sqp_single.cuh's section ids, in order (SEC_COUNT of them).
SECTIONS = ("qp", "rows", "reductions", "hbar", "factor", "residuals",
            "gbar", "vector_sweeps", "update", "linearize", "mirror",
            "merit", "step", "f_pab", "f_q", "f_lf", "f_k", "f_sp",
            "v_bwd", "v_fwd", "n_ip", "n_sqp", "total")
#: Sections counted per interior-point iteration and per SQP iteration.
#: The factor's phases (f_*) and the corrector sweep's halves (v_*) lie
#: inside "factor" and "vector_sweeps"; they are counted apart.
PER_IP = ("rows", "reductions", "hbar", "factor", "residuals", "gbar",
          "vector_sweeps", "update")
PARTS = ("f_pab", "f_q", "f_lf", "f_k", "f_sp", "v_bwd", "v_fwd")
PER_SQP = ("qp", "linearize", "mirror", "merit", "step")

GOLDEN_CFG = dict(n_sqp=30, n_qp_iter=20, mu_min=1e-10)
XLA_PLANS = 8
#: Plans (of 9 problems) of the ``"xla"`` batches ``--times`` times.
SWEEP_PLANS = (8, 14, 15, 29, 30, 60, 128, 512)


def _golden():
    gold = np.load(os.path.join(common.ROOT, "tests", "golden",
                                "contouring_2obs.npz"))
    return (common.basic_ocp(15, 2), SQPConfig(**GOLDEN_CFG),
            (gold["P"][None], gold["x0"][None], gold["z_init"][None]),
            torch.float64)


def _basic():
    ocp, P, x0, z = common.basic_problem()
    return (ocp, SQPConfig(n_sqp=10, n_qp_iter=18),
            (P[None], x0[None], z[None]), torch.float64)


def _demo():
    from ..examples import demo_fleet_processes

    ocp, P, x0, z = common.goal_demo_problem(10)
    return (ocp, SQPConfig(**demo_fleet_processes.ROBOT_SQP),
            (P[None], x0[None], z[None]), torch.float64)


def _xla(plans=XLA_PLANS):
    ocp, (params, xinit, z_init, _) = common.bench_fleet(
        plans, torch.float32, "cpu")
    B, P = params.shape[:2]
    args = (params.reshape(B * P, *params.shape[2:]).numpy(),
            xinit.repeat_interleave(P, dim=0).numpy(),
            z_init.reshape(B * P, *z_init.shape[2:]).numpy())
    return ocp, common.bench_config(), args, torch.float32


#: name -> () -> (ocp, SQPConfig, numpy (all_params, xinit, z_init), dtype)
CASES = {"golden": _golden, "basic_tick": _basic, "demo": _demo,
         "xla_fleet": _xla, "xla_bench": lambda: _xla(common.BENCH_BATCH)}


def _sections_library():
    info = qp_cuda.build_all(("sqp_single",), defines=("S1_SECTIONS",))
    lib = ctypes.CDLL(info["sqp_single"].path)
    sqp_single._bind(lib, ("_f32", "_f64"))
    lib.sqp_single_sections.argtypes = [ctypes.c_void_p] * 2
    lib.sqp_single_sections.restype = ctypes.c_int
    return lib


def _plan(dtype, tables, problems) -> dict:
    try:
        return sqp_single.launch_info(dtype, tables, problems)
    except TypeError:  # an older wrapper: one plan for any batch
        return sqp_single.launch_info(dtype, tables)


def _read_sections(lib) -> dict:
    out = torch.zeros(len(SECTIONS), dtype=torch.int64, device="cuda")
    err = lib.sqp_single_sections(out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sqp_single_sections failed ({err})")
    return dict(zip(SECTIONS, out.tolist()))


def split(sec: dict) -> dict:
    """Cycles per interior-point iteration (``PER_IP``) and per SQP
    iteration (``PER_SQP``) of one launch's counters."""
    n_ip, n_sqp = max(sec["n_ip"], 1), max(sec["n_sqp"], 1)
    return dict(per_ip={k: sec[k] / n_ip for k in PER_IP},
                parts_per_ip={k: sec[k] / n_ip for k in PARTS},
                per_sqp={k: sec[k] / n_sqp for k in PER_SQP},
                n_ip=sec["n_ip"], n_sqp=sec["n_sqp"], total=sec["total"])


def _case(lib, make, reps) -> dict:
    """One case's time per launch and plan on the default build; with
    ``lib`` (the section build) its split and whether both builds give the
    same bits."""
    ocp, cfg, args, dtype = make()
    solve = sqp_single.make_single_solver(ocp, cfg, dtype=dtype,
                                          device=torch.device("cuda", 0))
    x_in = solve.layout(*args)
    ms, _ = common.cuda_time_ms(lambda: solve.launch(x_in), reps=reps)
    problems = int(x_in.shape[0])
    row = dict(T=ocp.N + 1, problems=problems, dtype=str(dtype)[6:], ms=ms,
               plan=_plan(dtype, solve.tables, problems))
    if lib is not None:
        want = solve.launch(x_in)
        _read_sections(lib)  # zeroes the counts of earlier launches
        got = solve.launch(x_in, lib=lib)
        row["split"] = split(_read_sections(lib))
        row["builds_equal"] = common.same_bits(got, want)
    return row


def run(times_only=False, reps=20) -> dict:
    result = dict(card=common.card_line(), cases={}, sweep={})
    lib = None if times_only else _sections_library()
    for name, make in CASES.items():
        result["cases"][name] = row = _case(lib, make, reps)
        print(f"{name}: {json.dumps(row)}", flush=True)
    for plans in SWEEP_PLANS:
        row = _case(None, lambda: _xla(plans), reps)
        result["sweep"][row["problems"]] = row
        print(f"xla x {row['problems']}: {json.dumps(row)}", flush=True)
    return result


def main(argv=None) -> int:
    faulthandler.enable()
    common.require_card("s1_sections")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true",
                    help="time the default build alone")
    ap.add_argument("--out", default=os.path.join(common.ROOT, "build",
                                                  "s1_sections.json"))
    a = ap.parse_args(argv)
    result = run(times_only=a.times)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
