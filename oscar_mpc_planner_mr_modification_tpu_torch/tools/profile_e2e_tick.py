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

``SPANS=1`` (:func:`spans`) instead profiles the deployed planner: the
jackalsimulator settings (N=30, f64, 10 SQP x 18 IP iterations) at
``SPANS_CONFIG`` (``tmpc_consistency_cost``, the default, or ``basic``) in
the same scene, ``SPAN_TICKS`` ticks after ``WARM`` traced by
``torch.profiler`` with the program's spans as profiler ranges
(``utils/profiling.py``). Per span it prints the calls a tick, the total
and self ms a tick and the device's idle ms inside the span's self time
(each idle interval split over the spans that cover its parts, innermost
first), then the idle outside every span, ``solve_builds`` and the
T-MPC planners solved, enabled and useful a tick; with
``SPANS_TRACE=<path>`` it writes the chrome trace there.

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
from ..utils.profiling import BENCHMARKERS, profiler_ranges
from .bench import e2e_tick
from .common import (BENCH_N, SimClock, TickScene, require_card, sync,
                     tick_scene)

WARM, TICKS, HOST_TICKS, SPAN_TICKS = 4, 20, 36, 40
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


def owners(spans, lo, hi):
    """``[(start, end, name)]`` covering [lo, hi] in order: each piece's
    innermost span of ``spans`` (``(name, start, end)``, nested as one
    thread's spans are), None where no span is open."""
    pieces, stack, t = [], [], lo

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][2] <= limit:
            name, _, end = stack.pop()
            pieces.append((t, end, name))
            t = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(a)
        pieces.append((t, a, stack[-1][0] if stack else None))
        t = a
        stack.append((name, a, b))
    close_until(np.inf)
    pieces.append((t, hi, None))
    return [(max(a, lo), min(b, hi), n) for a, b, n in pieces
            if min(b, hi) > max(a, lo)]


def idle_split(spans, ops, lo, hi) -> dict:
    """Per span name (None: outside every span) ``{"self": s, "idle":
    s}``: its self time in [lo, hi] and the device's idle time inside it,
    with ``ops`` the device's ``(start, end)`` intervals."""
    busy = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in ops):
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out, i = {}, 0
    for a, b, name in owners(spans, lo, hi):
        row = out.setdefault(name, {"self": 0.0, "idle": 0.0})
        row["self"] += b - a
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            row["idle"] += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
    return out


def spans(device="cuda", configuration=None, warm=WARM, ticks=None,
          trace_path=None) -> dict:
    """``ticks`` (``SPAN_TICKS``) ticks of the deployed planner at
    ``configuration`` after ``warm``, traced with the program's spans as
    profiler ranges; prints and returns ``rows`` (per span: ``calls``,
    ``total_ms``, ``self_ms``, ``idle_ms``, each a tick), ``outside_idle_ms``,
    ``tick_ms``, ``busy_ms`` (the device, a tick), ``solve_builds`` and
    ``planners`` (solved, enabled, useful a tick)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..factory import prewarm_planner
    from ..systems import make_system_planner

    cuda = torch.device(device).type == "cuda"
    if cuda:
        require_card("profile_e2e_tick")
    configuration = configuration or os.environ.get(
        "SPANS_CONFIG", "tmpc_consistency_cost")
    ticks = ticks or SPAN_TICKS
    trace_path = trace_path or os.environ.get("SPANS_TRACE")
    clock = SimClock()
    planner, model, settings = make_system_planner(
        "jackalsimulator", configuration, device=device, clock=clock)
    prewarm_planner(planner, model, settings)
    scene = TickScene(planner, model, settings, clock)
    state = scene.reset()
    planner.on_data_received(scene.build_data(state), "reference_path")

    def tick():
        scene.psim.step([state.get_position()])
        out = planner.solve_mpc(state, scene.build_data(state))
        scene.advance(*scene.command(out))

    for _ in range(warm):
        tick()
    sync(device)
    BENCHMARKERS.reset()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    before = profiler_ranges(True)
    try:
        with profile(activities=activities, record_shapes=True) as prof:
            for _ in range(ticks):
                tick()
            sync(device)
    finally:
        profiler_ranges(before)
    names = {n for n in BENCHMARKERS.names() if BENCHMARKERS.get(n).count}
    host, ops = [], []
    for ev in prof.events():
        iv = (ev.time_range.start * 1e-3, ev.time_range.end * 1e-3)  # ms
        if ev.name in names:
            if ev.device_type != DeviceType.CUDA:  # not the range's copy
                host.append((ev.name, *iv))
        elif ev.device_type == DeviceType.CUDA:
            ops.append(iv)
    lo, hi = min(s[1] for s in host), max(s[2] for s in host)
    split = idle_split(host, ops, lo, hi)
    n_ticks = sum(1 for s in host if s[0] == "plan")
    rows = {}
    for name in sorted(names, key=lambda n: -BENCHMARKERS.get(n).total):
        mine = [b - a for n, a, b in host if n == name]
        rows[name] = dict(calls=len(mine) / n_ticks,
                          total_ms=sum(mine) / n_ticks,
                          self_ms=split.get(name, {}).get("self", 0.0)
                          / n_ticks,
                          idle_ms=split.get(name, {}).get("idle", 0.0)
                          / n_ticks)
    outside = split.get(None, {"idle": 0.0})["idle"] / n_ticks
    busy_ms = (hi - lo - sum(r["idle"] for r in split.values())) / n_ticks
    planners = {k: BENCHMARKERS.counter(f"tmpc.planners_{k}") / n_ticks
                for k in ("solved", "enabled", "useful")}
    result = dict(rows=rows, outside_idle_ms=outside,
                  tick_ms=(hi - lo) / n_ticks, busy_ms=busy_ms,
                  solve_builds=BENCHMARKERS.counter("solve_builds"),
                  planners=planners, ticks=n_ticks)
    solver = planner.solver
    print(f"spans of {n_ticks} traced ticks ({configuration}, "
          f"N={solver.N}, {str(solver.dtype).split('.')[-1]}, "
          f"{solver.config.n_sqp} x {solver.config.n_qp_iter}, {device}); "
          f"ms a tick:", flush=True)
    print(f"{'span':<16} {'calls':>6} {'total':>9} {'self':>9} "
          f"{'idle in self':>12}")
    for name, r in rows.items():
        print(f"{name:<16} {r['calls']:6.2f} {r['total_ms']:9.3f} "
              f"{r['self_ms']:9.3f} {r['idle_ms']:12.3f}")
    print(f"idle outside every span {outside:.3f}; traced tick "
          f"{result['tick_ms']:.3f}, device busy {busy_ms:.3f}; "
          f"solve_builds {result['solve_builds']}; planners a tick: "
          + ", ".join(f"{k} {v:.3f}" for k, v in planners.items()),
          flush=True)
    if trace_path:
        prof.export_chrome_trace(trace_path)
        print(f"chrome trace: {trace_path}")
    return result


if __name__ == "__main__":
    if os.environ.get("SPANS"):
        spans()
    elif os.environ.get("HOST_ONLY"):
        host_only()
    else:
        main()
