"""The reduction from a trace to the per-layer metrics, on a synthetic
window."""

from types import SimpleNamespace

import numpy as np
import pytest

from cardbench import counts, metrics_context, trace
from cardbench.trace import Trace


def synthetic():
    """A 1 s window: two ticks; kernels of 0.1 s and 0.2 s in the first,
    0.3 s in the second, one overlapping the last; a guidance span."""
    ops = [("void qp_ip_kernel<double, 5, 2, false>(x)", 0.10, 0.20),
           ("void (anonymous namespace)::mirror_block_kernel<double, M>(y)",
            0.25, 0.45),
           ("void qp_ip_kernel<double, 5, 2, false>(x)", 0.60, 0.90),
           ("Memcpy DtoH (Device -> Pageable)", 0.85, 0.95)]
    spans = [("cardbench.window", 0.0, 1.0), ("cardbench.tick", 0.0, 0.5),
             ("cardbench.tick", 0.5, 1.0), ("cardbench.guidance", 0.0, 0.1)]
    return Trace(ops, spans, (0.0, 1.0))


def test_union_and_busy():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    tr = synthetic()
    assert trace.busy_seconds(tr) == pytest.approx(0.1 + 0.2 + 0.35)
    busy = trace.Busy(tr)
    assert busy.between(0.0, 0.5) == pytest.approx(0.3)
    assert busy.between(0.5, 1.0) == pytest.approx(0.35)
    assert busy.between(0.15, 0.3) == pytest.approx(0.1)


def test_breakdown_names_and_gaps():
    b = trace.breakdown(synthetic())
    names = dict(b["device_ops"])
    assert names["void qp_ip_kernel<double, 5, 2, false>"] == pytest.approx(
        0.4)
    assert "void mirror_block_kernel<double, M>" in names
    gaps = dict(b["idle_gaps"])
    assert gaps["guidance"] == pytest.approx(0.1)
    assert sum(gaps.values()) == pytest.approx(1.0 - 0.65)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def ctx(**kw):
    base = dict(trace=synthetic(), busy_s=0.65, window_s=1.0, kind="tick",
                ticks=2, plans=2, problems=5,
                config={"dtype": "float64"})
    base.update(kw)
    return SimpleNamespace(**base)


def test_host_ms_idle_and_per_plan():
    c = ctx()
    assert metrics_context.host_ms_per_tick(c) == pytest.approx(
        1e3 * ((0.5 - 0.3) + (0.5 - 0.35)) / 2)
    assert metrics_context.idle_percent(c) == pytest.approx(35.0)
    assert metrics_context.per_plan(c, 42) == 21
    assert metrics_context.per_plan(ctx(kind="fleet", plans=1024), 21) == \
        pytest.approx(21 / 1024)
    assert metrics_context.host_ms_per_tick(ctx(trace=None)) is None


def test_roofline_share_is_least_time_over_kernel_time():
    c = ctx()
    flops, words = 1e9, 1e3  # per problem
    share = metrics_context.roofline_share(c, r"qp_ip_kernel",
                                           lambda _: (flops, words))
    least = max(5e9 / counts.PEAK_FLOPS["float64"],
                5e3 * 8 / counts.PEAK_BYTES_PER_S)
    assert share == pytest.approx(100 * 2 * least / 0.4)
    assert metrics_context.roofline_share(c, r"no_such_kernel",
                                          lambda _: (1, 1)) is None


def test_a_reader_of_nothing_returns_none():
    from cardbench import run
    from helpers import ROOT

    c = ctx(trace=None, guidance_s=0.0, launches=None)
    for name in ("host_ms.tick", "guidance_ms.tick", "idle_share.tick",
                 "b1_lanes_roofline.tick", "launches_per_plan.tick"):
        assert run.reader(ROOT, name)(c) is None


def test_percentile_and_rates_over_all_ticks():
    """The end-to-end arithmetic: p95 of every tick, ticks over the whole
    window (not medians of chunks)."""
    times = np.linspace(0.01, 0.05, 101)
    assert np.percentile(times, 95) == pytest.approx(0.048)
