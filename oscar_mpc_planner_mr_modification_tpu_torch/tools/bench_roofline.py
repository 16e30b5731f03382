"""The card's FP32 roof (kernel B3), its matmul ceilings, and the achieved
FLOP/s of the fleet paths.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_roofline

Counterpart of the JAX package's ``tools/bench_roofline.py``, on one CUDA
device, every time by CUDA events:

1. the FP32 roof: kernel B3 (``csrc/fma_roof.cu``, 8 independent chains of
   256 FMAs per thread) at the TPU tool's (8, 256, 512), 100 launches per
   sample because one launch is a few microseconds, and at (8, 4096, 4096),
   where one launch is about 1 ms; the roof is the larger rate;
2. chains of 8 square 2048^3 ``torch.matmul`` products in f32 (TF32 off, so
   full f32) and bf16: what the card gives a matmul-shaped workload;
3. the bench fleet step (512 plans x 9 planners, N=20, f32, schedule
   1x3+1x5+2x8) through ``backend`` fused, lanes and pallas: step ms,
   plans/s, and the achieved TFLOP/s, both by the JAX bench's convention
   (``ALGO_FLOPS_PER_PROBLEM``) and by the full count of linearizations and
   interior-point iterations (``roofline.sqp_flops``), each with its share
   of the measured roof and of the published 67 TFLOP/s.

Prints one JSON line with the card's name and power limit. Without a CUDA
device it exits with code 2.
"""

from __future__ import annotations

import json
import math

import torch

from ..ops import roofline
from .common import (BENCH_SCHEDULE, bench_config, bench_fleet, card_line,
                     cuda_time_ms, require_card)

#: (shape, launches per timed sample) of the two roof measurements.
ROOF_SHAPES = (((8, 256, 512), 100), ((8, 4096, 4096), 1))
MATMUL_N, MATMUL_CHAIN = 2048, 8


def fma_rate(shape, inner: int, reps: int = 10) -> dict:
    """B3's time per launch and FLOP rate on a random f32 input of
    ``shape``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, device="cuda", generator=gen)
    ms, _ = cuda_time_ms(lambda: roofline.fma_roof(x), reps, inner=inner)
    return {"shape": list(shape), "ms": ms,
            "tflops": roofline.fma_flops(x.numel()) / ms / 1e9}


def roof(reps: int = 10) -> dict:
    """The FP32 roof: B3 at both sizes; ``tflops`` is the larger rate."""
    rates = [fma_rate(shape, inner, reps) for shape, inner in ROOF_SHAPES]
    return {"tflops": max(r["tflops"] for r in rates), "sizes": rates}


def matmul_rate(dtype, reps: int = 5) -> float:
    """TFLOP/s of a chain of ``MATMUL_CHAIN`` dependent square products of
    size ``MATMUL_N`` in ``dtype``, TF32 off."""
    n = MATMUL_N
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((n, n), device="cuda", generator=gen).to(dtype)
    w = (torch.randn((n, n), device="cuda", generator=gen)
         / math.sqrt(n)).to(dtype)

    def chain():
        y = x
        for _ in range(MATMUL_CHAIN):
            y = torch.matmul(y, w)
        return y

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms, _ = cuda_time_ms(chain, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * n ** 3 * MATMUL_CHAIN / ms / 1e9


def achieved(step_ms: float, n_problems: int, roof_tflops: float,
             schedule=BENCH_SCHEDULE) -> dict:
    """Achieved TFLOP/s of one fleet step of ``step_ms``, by the JAX
    convention and by the full count, with their shares of the measured roof
    and of the published FP32 peak."""
    out = {}
    for key, flops in (
            ("algo", roofline.ALGO_FLOPS_PER_PROBLEM * n_problems),
            ("full", roofline.sqp_flops(n_problems, schedule))):
        tflops = flops / step_ms / 1e9
        out[f"{key}_tflops"] = tflops
        out[f"{key}_share_of_roof"] = tflops / roof_tflops
        out[f"{key}_share_of_peak"] = tflops / (roofline.PEAK_FP32_FLOPS / 1e12)
    return out


def fleet_step_ms(backend: str, ocp, args, reps: int) -> float:
    """Median ms of the bench fleet step through ``backend``."""
    from ..parallel.batch import make_batched_tmpc_step

    step = make_batched_tmpc_step(ocp, bench_config(), dtype=torch.float32,
                                  backend=backend)
    ms, _ = cuda_time_ms(lambda: step(*args), reps, warmup=1)
    return ms


def main():
    require_card("bench_roofline")
    result = {"card": card_line(), "device": torch.cuda.get_device_name(0),
              "peak_fp32_tflops": roofline.PEAK_FP32_FLOPS / 1e12}
    result["fma_roof"] = roof()
    result["matmul_f32_tflops"] = matmul_rate(torch.float32)
    result["matmul_bf16_tflops"] = matmul_rate(torch.bfloat16)
    ocp, args = bench_fleet()
    n_problems = args[0].shape[0] * args[0].shape[1]
    result["fleet_problems"] = n_problems
    for backend, reps in (("fused", 5), ("lanes", 5), ("pallas", 3)):
        ms = fleet_step_ms(backend, ocp, args, reps)
        result[backend] = {"step_ms": ms,
                           "plans_per_s": args[0].shape[0] / ms * 1e3,
                           **achieved(ms, n_problems,
                                      result["fma_roof"]["tflops"])}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
