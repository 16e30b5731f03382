"""What the tools share: the card's identity, CUDA-event timing, and the
bench fleet of ``bench.py`` (512 plans x 9 planners, N=20, f32)."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

BENCH_SCHEDULE = ((1, 3), (1, 5), (2, 8))
BENCH_BATCH, BENCH_N, BENCH_PATHS = 512, 20, 8


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def require_card(tool: str):
    """Exit with code 2 unless a CUDA device is present."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        sys.exit(2)


def cuda_time_ms(fn, reps: int, warmup: int = 2, inner: int = 1):
    """``(median, all)`` ms per call of ``fn`` by CUDA events, each sample
    over ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times)), times


def bench_fleet(batch=BENCH_BATCH, dtype=torch.float32, device="cuda",
                N=BENCH_N):
    """The bench OCP and its fleet (seed 0) as tensors on ``device``."""
    from ..benchmarks import build_tmpc_fleet, tmpc_bench_ocp
    from ..parallel.batch import to_torch_fleet

    ocp, settings = tmpc_bench_ocp(N=N, n_paths=BENCH_PATHS)
    arrays = build_tmpc_fleet(ocp, settings, batch, seed=0)
    return ocp, to_torch_fleet(*arrays, device=device, dtype=dtype)


def bench_config():
    """The bench's SQP operating point (schedule 1x3+1x5+2x8, Gershgorin,
    last iterate)."""
    from ..ops.sqp import SQPConfig

    return SQPConfig(n_sqp=sum(n for n, _ in BENCH_SCHEDULE),
                     n_qp_iter=BENCH_SCHEDULE[-1][1], mu_min=1e-6, w_max=1e6,
                     reg_eps=1e-4, regularization="gershgorin",
                     track_best=False, qp_iter_schedule=BENCH_SCHEDULE)
