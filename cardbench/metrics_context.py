"""What a per-layer metric's reader reads (``cardbench/metrics/<name>.py``,
each with ``read(ctx) -> float | None``), and the helpers they share. A
reader that finds nothing to read returns None and the metric is left out
of the result line."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import counts, trace as trace_mod
from .reference import ocp as ref_ocp


def build(job, outcome) -> SimpleNamespace:
    c = outcome.context
    tr = (trace_mod.from_profiler(c["prof"]) if c.get("prof") is not None
          else None)
    ctx = SimpleNamespace(job=job, config=job.config, traffic=job.traffic,
                          trace=tr, **{k: v for k, v in c.items()
                                       if k != "prof"})
    if tr is not None:
        ctx.busy_s = trace_mod.busy_seconds(tr)
        ctx.window_s = tr.window_s
        ctx.breakdown = trace_mod.breakdown(tr)
    else:
        ctx.busy_s, ctx.breakdown = None, None
    return ctx


def per_plan(ctx, value):
    """``value`` per tick, or per robot plan of a fleet step."""
    n = ctx.ticks if ctx.kind == "tick" else ctx.plans
    return None if value is None or not n else value / n


def _ocp(ctx):
    return ref_ocp.build(ctx.config["reference"])


def roofline_share(ctx, pattern, work):
    """Per cent of its roofline that the kernels matching ``pattern``
    reach over the window: the least time of every launch's work (each
    launch on ``ctx.problems`` problems; ``work(ctx)`` gives one problem's
    operations and words) over the time they took."""
    if ctx.trace is None:
        return None
    times = trace_mod.kernel_times(ctx.trace, pattern)
    if not times:
        return None
    flops_per_problem, words_per_problem = work(ctx)
    dtype = ctx.config["dtype"]
    least, _ = counts.least_seconds(
        flops_per_problem * ctx.problems,
        words_per_problem * ctx.problems * counts.ITEMSIZE[dtype], dtype)
    return 100.0 * least * len(times) / float(np.sum(times))


def qp_sizes(ctx):
    ocp = _ocp(ctx)
    meta = ref_ocp.row_meta(ocp)
    mask = ref_ocp.stage_mask(ocp)
    mh = sum(1 for m in meta if m[0] == "h")
    return ocp, meta, mask, mh


def lane_qp_work(ctx):
    """(operations, words) of one problem's lane QP solve."""
    ocp, meta, mask, mh = qp_sizes(ctx)
    T = ocp.N + 1
    n_iter = int(ctx.config["reference"]["sqp"]["n_qp_iter"])
    flops = n_iter * counts.ip_iter_flops(meta, mask, ref_ocp.NX, ref_ocp.NU)
    words = counts.qp_words(T, ref_ocp.NX, ref_ocp.NU, len(meta), mh)
    return flops, words


def lane_linearize_work(ctx):
    """(operations, words) of one problem's mirror linearization with its
    merit terms: the parameters, state and iterate read, the QP fields and
    three merit terms written."""
    ocp, meta, mask, mh = qp_sizes(ctx)
    T = ocp.N + 1
    c = ctx.config["counts"]
    fields = counts.qp_words(T, ref_ocp.NX, ref_ocp.NU, len(meta), mh) \
        - T * ref_ocp.NZ
    words = ocp.npar * T + ref_ocp.NX + T * ref_ocp.NZ + fields + 3
    return c["lin_mirror"] + c["merit"], words


def single_work(ctx):
    """(operations, words) of one problem's whole single-instance solve."""
    ocp = _ocp(ctx)
    T = ocp.N + 1
    s = ctx.config["reference"]["sqp"]
    flops = counts.single_flops(int(s["n_sqp"]), int(s["n_qp_iter"]),
                                ctx.config["counts"], T, ref_ocp.NZ)
    words = ocp.N * ocp.npar + ref_ocp.NX + 2 * T * ref_ocp.NZ + 5
    return flops, words


def host_ms_per_tick(ctx):
    """Mean over the window's ticks of the wall time less the device's busy
    time inside the tick, in ms."""
    if ctx.trace is None:
        return None
    ticks = [(a, b) for name, a, b in ctx.trace.spans
             if name == "cardbench.tick"]
    if not ticks:
        return None
    busy = trace_mod.Busy(ctx.trace)
    host = [(b - a) - busy.between(a, b) for a, b in ticks]
    return 1e3 * float(np.mean(host))


def idle_percent(ctx):
    if ctx.trace is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
