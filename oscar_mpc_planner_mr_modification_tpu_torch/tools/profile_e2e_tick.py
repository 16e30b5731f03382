"""Where the host's time goes in the single-robot tick on one CUDA device;
the port's counterpart of the JAX package's ``tools/profile_e2e_tick.py``.

    python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.profile_e2e_tick
    HOST_ONLY=1 [PROFILE=1] python -m \\
        oscar_mpc_planner_mr_modification_tpu_torch.tools.profile_e2e_tick

Both run the bench's serial tick (``tools/bench.py::e2e_tick``, the
garbage collector off in each tick) of ``tools/common.py::tick_scene``
(``BENCH_N``, 20 by default; 5 planners, 12 crossing pedestrians) at the
JAX tool's SQP config (``PROFILE_CONFIG``: 10 SQP x 8 IP iterations under
"mirror", the last iterate), f32: the ``"lanes"`` backend, per tick 10
launches each of the mirror linearize entry and B1's field entry and one
merit launch:

- :func:`main`: ``WARM`` ticks, then cProfile over ``TICKS`` ticks from the
  scene's start; prints each warm tick, the ticks' median, p90 and max, and
  the cumulative stats;
- :func:`host_only` (``HOST_ONLY=1``): ``HOST_TICKS`` ticks after ``WARM``,
  each tick's host time = its wall time minus its wait on the device
  (``TMPCOptimizer.last_fetch_wait``); ``PROFILE=1`` adds cProfile.

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats

import numpy as np
import torch

from ..ops.sqp import SQPConfig
from .bench import e2e_tick
from .common import BENCH_N, require_card, tick_scene

WARM, TICKS, HOST_TICKS = 4, 20, 36
#: The JAX tool's SQP config (its ``tools/profile_e2e_tick.py``).
PROFILE_CONFIG = SQPConfig(n_sqp=10, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                           reg_eps=1e-4, regularization="mirror",
                           track_best=False)
#: Lines of the cumulative stats each mode prints.
TOP, HOST_TOP = 45, 60


def _stats(pr, top: int) -> str:
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(top)
    return s.getvalue()


def _scene(device, N):
    if torch.device(device).type == "cuda":
        require_card("profile_e2e_tick")
    return tick_scene(device, torch.float32,
                      N or int(os.environ.get("BENCH_N", BENCH_N)),
                      config=PROFILE_CONFIG)


def main(device="cuda", N=None, warm=WARM, ticks=TICKS) -> dict:
    """``warm`` ticks, then cProfile of ``ticks`` ticks from the scene's
    start; returns the profiled ticks' ``median_ms``, ``p90_ms``,
    ``max_ms``, ``host_median_ms`` and the ``stats`` text."""
    scene = _scene(device, N)
    warm_ms, _ = e2e_tick(scene, "serial", warm, skip=0)
    for i, t in enumerate(warm_ms):
        print(f"warm tick {i}: {t:.1f} ms", flush=True)
    pr = cProfile.Profile()
    pr.enable()
    t, host_ms = e2e_tick(scene, "serial", ticks, skip=0)
    pr.disable()
    print(f"ticks: median {np.median(t):.2f} ms  p90 "
          f"{np.percentile(t, 90):.2f}  max {t.max():.2f}")
    stats = _stats(pr, TOP)
    print(stats, flush=True)
    return dict(median_ms=float(np.median(t)),
                p90_ms=float(np.percentile(t, 90)), max_ms=float(t.max()),
                host_median_ms=float(np.median(host_ms)), stats=stats)


def host_only(device="cuda", N=None, warm=WARM, ticks=HOST_TICKS,
              profile=None) -> dict:
    """The host's time per tick over ``ticks`` ticks after ``warm`` of one
    run (cProfile of the whole run with ``profile``, by default
    ``PROFILE``); returns ``host_median_ms``, ``host_p90_ms``,
    ``host_max_ms``, ``tick_median_ms`` and ``stats`` (None without
    cProfile)."""
    if profile is None:
        profile = bool(os.environ.get("PROFILE"))
    scene = _scene(device, N)
    pr = cProfile.Profile()
    if profile:
        pr.enable()
    tick_ms, h = e2e_tick(scene, "serial", warm + ticks, skip=warm)
    pr.disable()
    print(f"HOST-ONLY per tick: median {np.median(h):.2f} ms  p90 "
          f"{np.percentile(h, 90):.2f}  max {h.max():.2f}", flush=True)
    stats = _stats(pr, HOST_TOP) if profile else None
    if stats:
        print(stats, flush=True)
    return dict(host_median_ms=float(np.median(h)),
                host_p90_ms=float(np.percentile(h, 90)),
                host_max_ms=float(h.max()),
                tick_median_ms=float(np.median(tick_ms)), stats=stats)


if __name__ == "__main__":
    if os.environ.get("HOST_ONLY"):
        host_only()
    else:
        main()
