"""BASELINE's f32 accuracy gates and a throughput sample on one CUDA device;
the port's counterpart of the JAX package's ``examples/validate_tpu.py``.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.validate

1. The gates (``tools/common.py::GATE_FLAVOURS``): goal tracking with 3
   ellipsoids (BASELINE config 1, N=20) and contouring with ellipsoids
   (config 2's flavour, N=15). Each golden's problem (``tests/golden/
   goal_tracking_3obs.npz``, ``contouring_2obs.npz``) is tiled to a fleet
   of 4 and solved at f32 with ``SQPConfig(n_sqp=25, n_qp_iter=15,
   Gershgorin)`` through ``backend="pallas"`` (kernel B1, one launch per
   SQP iteration). The gate: max |U32 - U64| <= 1e-3 over the fleet against
   the committed CPU-f64 controls (``validate_{goal,contouring}_U64.npy``).
2. Beside each, a diagnostic cross-check, not gated: the same problem
   through ``make_sqp_solver`` at f64 (n_sqp=30, n_qp_iter=20, mu_min
   1e-9), the single-instance solve (one launch of S1 on the card), with
   its time.
3. A throughput sample: ``make_batched_tmpc_step`` on the bench fleet
   (B=512 plans x 9 planners, N=20, f32) at ``SQPConfig(n_sqp=10,
   n_qp_iter=15, Gershgorin)`` through the port's default backend; median
   of 4 steps by the host clock, the device synchronized in each.

Exits with code 1 if a gate fails and 2 without a CUDA device.
``run(device="cpu", ...)`` runs the same through the plain versions.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops.sqp import SQPConfig, make_fleet_sqp_solver, make_sqp_solver
from .common import (GATE_B, GATE_CFG, GATE_FLAVOURS, GATE_TOL, bench_fleet,
                     card_line, gate_inputs, require_card, sync)

CROSS_CHECK_CFG = dict(n_sqp=30, n_qp_iter=20, mu_min=1e-9)
THROUGHPUT_CFG = dict(n_sqp=10, n_qp_iter=15, mu_min=1e-6, w_max=1e6,
                      reg_eps=1e-4, regularization="gershgorin")
THROUGHPUT_B, THROUGHPUT_REPS = 512, 4


def gate(flavour: str, backend: str = "pallas", device="cuda",
         dtype=torch.float32) -> dict:
    """One flavour of the gate through ``backend``: the golden's problem
    tiled to ``GATE_B`` copies at ``GATE_CFG``. Returns the fleet's result
    (``out``), its controls (``U``, (GATE_B, N, nu) numpy), the error
    against the committed controls (``err``, over every copy), and
    ``ok`` (err <= ``GATE_TOL`` and every copy solved)."""
    ocp, P, x0, z_init, U64 = gate_inputs(flavour)
    fleet = make_fleet_sqp_solver(ocp, SQPConfig(**GATE_CFG), dtype=dtype,
                                  device=device, backend=backend)
    out = fleet(np.tile(P[None], (GATE_B, 1, 1)),
                np.tile(x0[None], (GATE_B, 1)),
                np.tile(z_init[None], (GATE_B, 1, 1)))
    U = out.z.cpu().numpy()[:, :-1, :ocp.nu]
    err = float(np.abs(U - U64[None]).max())
    return dict(out=out, U=U, err=err,
                ok=err <= GATE_TOL and bool(out.success.all()))


def cross_check(flavour: str, device="cuda"):
    """The flavour's problem through ``make_sqp_solver`` at f64
    (``CROSS_CHECK_CFG``): ``(U (N, nu) numpy, ms)``."""
    ocp, P, x0, z_init, _ = gate_inputs(flavour)
    solve = make_sqp_solver(ocp, SQPConfig(**CROSS_CHECK_CFG),
                            dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    res = solve(P, x0, z_init)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return res.z.cpu().numpy()[:-1, :ocp.nu], ms


def throughput(device="cuda", batch=THROUGHPUT_B, reps=THROUGHPUT_REPS):
    """``(plans/s, best-of-9 success)`` of the bench fleet step at
    ``THROUGHPUT_CFG`` through ``make_batched_tmpc_step``'s default
    backend."""
    from ..parallel.batch import make_batched_tmpc_step

    ocp, args = bench_fleet(batch, torch.float32, device)
    step = make_batched_tmpc_step(ocp, SQPConfig(**THROUGHPUT_CFG),
                                  dtype=torch.float32, device=device)
    out = step(*args)
    sync(device)
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = step(args[0] + 1e-6 * i, *args[1:])
        sync(device)
        ts.append(time.perf_counter() - t0)
    return batch / float(np.median(ts)), float(out.any_success.float().mean())


def run(device="cuda", batch=THROUGHPUT_B, reps=THROUGHPUT_REPS) -> dict:
    """The gates, their cross-checks and the throughput sample, printed;
    returns ``{flavour: {err, ok, cross_check_delta, golden_vs_cross_check,
    cross_check_ms}, "plans_per_s", "success_rate", "ok"}``."""
    print(f"device: {device}"
          + (f" ({card_line()})" if torch.device(device).type == "cuda"
             else ""), flush=True)
    summary = {}
    for flavour in GATE_FLAVOURS:
        g = gate(flavour, "pallas", device)
        U64 = gate_inputs(flavour)[4]
        print(f"[{'PASS' if g['ok'] else 'FAIL'}] {flavour}: B1 ('pallas') "
              f"vs CPU-f64 golden control error = {g['err']:.2e} (gate "
              f"{GATE_TOL:g}), success={g['out'].success.tolist()}",
              flush=True)
        U_ref, ms = cross_check(flavour, device)
        delta = float(np.abs(g["U"] - U_ref[None]).max())
        golden_delta = float(np.abs(U64 - U_ref).max())
        print(f"       {flavour}: f64 make_sqp_solver cross-check delta = "
              f"{delta:.2e}, golden-vs-cross-check {golden_delta:.2e} "
              f"({ms:.1f} ms)", flush=True)
        summary[flavour] = dict(err=g["err"], ok=g["ok"],
                                cross_check_delta=delta,
                                golden_vs_cross_check=golden_delta,
                                cross_check_ms=ms)
    rate, success = throughput(device, batch, reps)
    print(f"throughput sample: {rate:.0f} T-MPC plans/s (success rate "
          f"{success:.3f})", flush=True)
    summary.update(plans_per_s=rate, success_rate=success,
                   ok=all(summary[f]["ok"] for f in GATE_FLAVOURS))
    return summary


def main():
    require_card("validate")
    from ..ops import qp_cuda

    qp_cuda.build_all()
    return 0 if run("cuda")["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
