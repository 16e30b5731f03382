"""Dual warm starts on the per-iteration path at the bench shape.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_warm

Counterpart of the JAX package's ``tools/bench_warm.py``: the T-MPC++ fleet
step (512 plans x 9 planners, N=20, f32) through ``backend="pallas"`` with
``n_sqp=10, n_qp_iter=15``, cold, and with ``n_qp_iter_warm`` 8 and 6
(iteration 0 cold with duals out, iterations 1-9 warm-started from the
previous QPs' multipliers). Prints one JSON line: per variant the step's ms
(CUDA events, median of 3), plans/s, best-of-9 success and the per-problem
success, and against the cold variant the ``any_success`` agreement and the
p99 of the relative cost difference, per problem where both solved it (as
the JAX tool) and per plan on the best cost, with the card's name and power
limit. ``split_ms`` splits one more step of each variant by where the time
goes: the host's ``torch.func`` linearization (``build_qp``, and
``merit_of`` with best-iterate tracking), the QP kernel's calls
(``solve_qp_batched`` / ``solve_qp_batched_duals``, wrapper and kernel), and
the rest, each part timed on the host clock with the device synchronized
before and after it. ``BENCH_BATCH`` and ``BENCH_N`` override the fleet
size. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..ops import qp_cuda
from ..ops.sqp import SQPConfig
from .common import (BENCH_BATCH, BENCH_N, bench_fleet, card_line,
                     cuda_time_ms, require_card)

#: The JAX tool's operating point (best-iterate tracking on, as its default).
BASE = SQPConfig(n_sqp=10, n_qp_iter=15, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
                 regularization="gershgorin")
VARIANTS = (("cold", BASE), ("warm8", BASE._replace(n_qp_iter_warm=8)),
            ("warm6", BASE._replace(n_qp_iter_warm=6)))


def summary(out) -> dict:
    """Best-of-9 and per-problem success of one step's result."""
    return {"success": out.any_success.float().mean().item(),
            "success_per_problem": out.all_success.float().mean().item()}


def against(out, ref) -> dict:
    """Against ``ref``: the ``any_success`` agreement; the p99 of the
    relative cost difference |c - c_ref| / (1 + |c_ref|) over the problems
    both solved (the JAX tool's ``cost_rel_p99_vs_cold``); and the same p99
    of the best cost over the plans both solved."""
    def p99(a, b, both):
        rel = ((a - b).abs() / (1.0 + b.abs()))[both]
        return rel.float().quantile(0.99).item() if rel.numel() else float("nan")

    return {"agreement": (out.any_success == ref.any_success).float()
            .mean().item(),
            "cost_rel_p99": p99(out.all_costs, ref.all_costs,
                                out.all_success & ref.all_success),
            "best_cost_rel_p99": p99(out.best_cost, ref.best_cost,
                                     out.any_success & ref.any_success)}


def split(step, args) -> dict:
    """ms of one step and of its parts: ``build_qp``, ``merit_of``, ``qp``
    (the QP kernel's calls) and ``rest``; ``calls`` counts each part."""
    mach = step.fleet_solve.machinery
    ms = dict.fromkeys(("build_qp", "merit_of", "qp"), 0.0)
    calls = dict.fromkeys(ms, 0)

    def timed(part, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[part] += (time.perf_counter() - t0) * 1e3
            calls[part] += 1
            return out
        return run

    saved = {name: getattr(mach, name) for name in ("build_qp", "merit_of")}
    saved_qp = {name: getattr(qp_cuda, name)
                for name in ("solve_qp_batched", "solve_qp_batched_duals")}
    try:
        for name, fn in saved.items():
            setattr(mach, name, timed(name, fn))
        for name, fn in saved_qp.items():
            setattr(qp_cuda, name, timed("qp", fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in saved.items():
            setattr(mach, name, fn)
        for name, fn in saved_qp.items():
            setattr(qp_cuda, name, fn)
    return {"step": total, **ms, "rest": total - sum(ms.values()),
            "calls": calls}


def main():
    from ..parallel.batch import make_batched_tmpc_step

    require_card("bench_warm")
    B = int(os.environ.get("BENCH_BATCH", BENCH_BATCH))
    N = int(os.environ.get("BENCH_N", BENCH_N))
    ocp, args = bench_fleet(B, N=N)
    result = {"card": card_line(), "device": torch.cuda.get_device_name(0),
              "batch": B * args[0].shape[1], "plans": B, "horizon": N}
    ref = None
    for name, cfg in VARIANTS:
        step = make_batched_tmpc_step(ocp, cfg, dtype=torch.float32,
                                      backend="pallas")
        out = step(*args)
        ms, _ = cuda_time_ms(lambda: step(*args), reps=3, warmup=0)
        row = {"ms": ms, "plans_per_s": B / ms * 1e3, **summary(out),
               "split_ms": split(step, args)}
        if ref is None:
            ref = out
        else:
            row.update({f"{k}_vs_cold": v for k, v in against(out, ref).items()})
        result[name] = row
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
