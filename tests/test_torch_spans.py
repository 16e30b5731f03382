"""The port's spans and counters (``utils/profiling.py``) over a few ticks
of the jackalsimulator planner on the CPU, at both tick configurations:
one ``plan`` root a tick with its phases nested inside it, the
``guidance`` and ``optimization`` intervals around the calls they time,
the T-MPC counters against the planners' masks, the bounded
``Benchmarker``, and the profiler ranges: absent with the switch off,
each span with its tick with it on.

The spans, not the plans, are under test: after one real solve (N=8, 2
SQP x 6 IP iterations) every tick's solve returns that solve's result, so
that a traced tick holds the planner's host work and not the thousands of
operations of the CPU solve.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig
from oscar_mpc_planner_mr_modification_tpu_torch.systems import (
    make_system_planner)
from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
    SimClock, TickScene)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import profiling
from oscar_mpc_planner_mr_modification_tpu_torch.utils.profiling import (
    BENCHMARKERS, WINDOW, Benchmarker, profiler_ranges, span)

TICKS = 3
CONFIG = SQPConfig(n_sqp=2, n_qp_iter=6, regularization="mirror")
#: Each span's parent in one serial tick.
PARENTS = {
    "tmpc_consistency_cost": {
        "plan.warmstart": "plan", "plan.modules": "plan", "plan.fill": "plan",
        "guidance": "plan.modules", "optimization": "plan",
        "tmpc.assemble": "optimization", "launch": "optimization",
        "select": "optimization", "fetch_wait": "select",
        "plan.output": "plan"},
    "basic": {
        "plan.warmstart": "plan", "plan.modules": "plan", "plan.fill": "plan",
        "optimization": "plan", "launch": "optimization",
        "select": "optimization", "fetch_wait": "select",
        "plan.output": "plan"},
}
ROOTS = {"plan", "prep.obstacles", "prep.prediction"}


class Replay:
    """A packed solve (``make_buffered_packed_solve``'s halves) that returns
    one packed result."""

    def __init__(self, packed):
        self.packed = packed

    def dispatch(self, params, xinit, warm):
        return None

    def fetch(self, handle):
        return self.packed.copy()


class Run:
    """A planner in its scene, the masks its ticks solved with, and what
    the calls that the ``guidance`` and ``optimization`` spans time saw."""

    def __init__(self, configuration):
        torch.set_num_threads(1)
        self.configuration = configuration
        clock = SimClock()
        planner, model, settings = make_system_planner(
            "jackalsimulator", configuration, device="cpu", clock=clock,
            sqp_config=CONFIG, N=8)
        self.planner = planner
        self.scene = TickScene(planner, model, settings, clock)
        self.state = self.scene.reset()
        planner.on_data_received(self.scene.build_data(self.state),
                                 "reference_path")
        self.tmpc = configuration != "basic"
        self.calls = {"guidance": [], "optimization": []}
        self.masks = []
        if self.tmpc:
            self._spy_tmpc()
        else:
            self._spy("optimization", planner.solver, "solve")

    def _spy(self, key, owner, attr):
        """Replace ``owner.attr`` by a call that records the innermost open
        span and its own duration."""
        inner = getattr(owner, attr)
        calls = self.calls[key]

        def call(*a, **k):
            innermost = profiling._OPEN.spans[-1].name
            s = time.perf_counter()
            out = inner(*a, **k)
            calls.append((innermost, time.perf_counter() - s))
            return out

        setattr(owner, attr, call)

    def _spy_tmpc(self):
        opt = self.scene.optimizer
        self.optimizer = opt
        self._spy("guidance", opt.global_guidance, "update")
        module = next(m for m in self.planner.modules
                      if hasattr(m, "_optimizer"))
        self._spy("optimization", module, "optimize")
        inner_dispatch, inner_fetch = opt._dispatch_batch, opt._fetch_batch

        def dispatch(*args):
            self.last_inputs = args
            return inner_dispatch(*args)

        def fetch():
            res = inner_fetch()
            self.masks[-1]["success"] = res.success.copy()
            return res

        inner_finish = opt.optimize_finish

        def finish(module_data):
            self.masks.append({"disabled": opt._pending_ctx[1].copy()})
            return inner_finish(module_data)

        opt._dispatch_batch = dispatch
        opt._fetch_batch = fetch
        opt.optimize_finish = finish

    def replay(self):
        """One real tick, then every solve returns its result."""
        self.tick()
        if self.tmpc:
            opt = self.optimizer
            full = self.planner.solver._iter_ladder[0]
            fn = opt._packed_solve[full]
            packed = fn.fetch(fn.dispatch(*self.last_inputs))
            opt._packed_solve[full] = Replay(packed)
        else:
            solver = self.planner.solver
            full = solver._iter_ladder[0]
            result = solver._ladder_fns[full](
                solver.params.data, solver._xinit, solver._loaded_warmstart)
            solver._ladder_fns[full] = lambda *args: result

    def tick(self):
        self.scene.psim.step([self.state.get_position()])
        data = self.scene.build_data(self.state)
        out = self.planner.solve_mpc(self.state, data)
        self.scene.advance(*self.scene.command(out))
        return out

    def snapshot(self):
        return {n: (b.count, b.total, b.self_total, list(b.durations))
                for n in BENCHMARKERS.names()
                for b in [BENCHMARKERS.get(n)] if b.count}


@pytest.fixture(scope="module", params=["tmpc_consistency_cost", "basic"])
def run(request):
    """One real tick; one tick traced with the ranges off; ``TICKS`` ticks
    with the registry reset before them, untraced; ``TICKS`` traced with
    the ranges on."""
    r = Run(request.param)
    r.replay()
    with profile(activities=[ProfilerActivity.CPU]) as off:
        r.tick()
    r.off_names = {e.name for e in off.events()}
    BENCHMARKERS.reset()
    r.masks.clear()
    for key in r.calls:
        r.calls[key].clear()
    for _ in range(TICKS):
        r.tick()
    r.registry = r.snapshot()
    r.counters = {n: BENCHMARKERS.counter(n) for n in (
        "tmpc.planners_solved", "tmpc.planners_enabled",
        "tmpc.planners_useful", "solve_builds")}
    r.ticks, r.root_total = BENCHMARKERS.ticks, BENCHMARKERS.root_total
    r.calls = {k: list(v) for k, v in r.calls.items()}
    r.mask_list = list(r.masks)
    BENCHMARKERS.reset()
    before = profiler_ranges(True)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as on:
            for _ in range(TICKS):
                r.tick()
    finally:
        profiler_ranges(before)
    r.on_registry = r.snapshot()
    r.on_events = [(e.name, e.time_range.start, e.time_range.end,
                    list(e.concrete_inputs or []))
                   for e in on.events() if e.name in r.on_registry]
    BENCHMARKERS.reset()
    return r


def test_one_plan_root_a_tick_and_its_phases_inside_it(run):
    reg, parents = run.registry, PARENTS[run.configuration]
    assert run.ticks == TICKS
    assert reg["plan"][0] == TICKS
    for name, parent in parents.items():
        assert reg[name][0] == TICKS, name
    assert set(reg) <= ROOTS | set(parents)
    for name, (count, total, own, durations) in reg.items():
        assert 0.0 <= own <= total + 1e-12, name
        assert total == pytest.approx(sum(durations), rel=1e-9), name
    # a parent's time less its self time is its children's time
    for parent in {"plan", *parents.values()}:
        children = sum(reg[c][1] for c, p in parents.items() if p == parent)
        assert children <= reg[parent][1]
        assert reg[parent][1] - reg[parent][2] == pytest.approx(
            children, rel=1e-9, abs=1e-12), parent
    roots = sum(reg[n][1] for n in ROOTS if n in reg)
    assert run.root_total == pytest.approx(roots, rel=1e-9)


def test_traced_spans_nest_in_their_tick_and_carry_its_id(run):
    """With the ranges on each span is a range of its name, as often as the
    registry counted it; every phase lies inside its tick's ``plan``, and
    each root range carries the tick it belongs to."""
    events = run.on_events
    counts = {}
    for name, *_ in events:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {n: v[0] for n, v in run.on_registry.items()}
    plans = sorted((a, b, ins) for n, a, b, ins in events if n == "plan")
    assert [ins for _, _, ins in plans] == [[k] for k in range(TICKS)]
    parents = PARENTS[run.configuration]
    for name, a, b, ins in events:
        if name in parents:
            inside = [i for i, (p0, p1, _) in enumerate(plans)
                      if p0 <= a and b <= p1]
            assert len(inside) == 1, name
            assert ins == [], name
        elif name in ("prep.obstacles", "prep.prediction"):
            # data preparation precedes the tick's plan and carries its id
            k = ins[0]
            assert b <= plans[k][0]
            assert k == 0 or a >= plans[k - 1][1]


def test_ranges_off_put_no_program_name_in_a_trace(run):
    assert not run.off_names & (set(run.registry) | {"plan"})


def test_guidance_and_optimization_time_the_calls_they_timed(run):
    """``guidance`` is ``GlobalGuidance.update`` alone; ``optimization`` the
    module's optimize or ``Solver.solve``: each call ran as the innermost
    span's body, once per span, within the span's duration."""
    reg = run.registry
    keys = ("guidance", "optimization") if run.tmpc else ("optimization",)
    for key in keys:
        calls = run.calls[key]
        assert [inner for inner, _ in calls] == [key] * TICKS
        durations = reg[key][3]
        assert len(durations) == len(calls)
        for (_, took), d in zip(calls, durations):
            assert took <= d
    if run.tmpc:
        assert reg["guidance"][1] == reg["guidance"][2]  # no span inside


def test_counters_match_the_planners_masks(run):
    c = run.counters
    assert c["solve_builds"] == 0
    if not run.tmpc:
        assert not any(c[k] for k in c if k.startswith("tmpc."))
        return
    P = run.optimizer.n_planners
    assert len(run.mask_list) == TICKS
    useful = sum(int(np.sum(m["success"] & ~m["disabled"]))
                 for m in run.mask_list)
    enabled = sum(int(np.sum(~m["disabled"])) for m in run.mask_list)
    assert c["tmpc.planners_solved"] == P * TICKS
    assert c["tmpc.planners_enabled"] == enabled
    assert c["tmpc.planners_useful"] == useful
    last_wait = run.on_registry["fetch_wait"][3][-1]
    assert run.optimizer.last_fetch_wait == last_wait


def test_reset_clears_spans_and_counters():
    with span("plan", tick=True):
        with span("launch"):
            pass
    BENCHMARKERS.count("solve_builds", 2)
    assert BENCHMARKERS.ticks == 1 and BENCHMARKERS.counter("solve_builds")
    BENCHMARKERS.reset()
    assert BENCHMARKERS.ticks == 0 and BENCHMARKERS.root_total == 0.0
    assert BENCHMARKERS.counter("solve_builds") == 0
    for name in ("plan", "launch"):
        b = BENCHMARKERS.get(name)
        assert (b.count, b.total, b.self_total, len(b.durations)) == (
            0, 0.0, 0.0, 0)


def test_benchmarker_totals_stay_exact_past_its_window():
    b = Benchmarker("window")
    values = [1e-3 * (i % 7 + 1) for i in range(WINDOW + 100)]
    for v in values:
        b.record(v, v / 2)
    assert b.count == len(values)
    assert b.total == pytest.approx(sum(values), rel=1e-12)
    assert b.self_total == pytest.approx(sum(values) / 2, rel=1e-12)
    assert list(b.durations) == values[-WINDOW:]
    assert b.last == values[-1]
    assert b.mean == pytest.approx(np.mean(values[-WINDOW:]))
    assert b.percentile(100) == max(values[-WINDOW:])


def test_the_two_phase_tick_records_the_shared_phases():
    """``solve_mpc_start`` / ``prepare`` / ``solve_mpc_finish`` record the
    spans inside the methods both paths call, and no ``plan``."""
    r = Run("tmpc_consistency_cost")
    r.replay()
    BENCHMARKERS.reset()
    planner, scene = r.planner, r.scene
    scene.psim.step([r.state.get_position()])
    data = scene.build_data(r.state)
    planner.solve_mpc_start(r.state, data)
    pred = planner.predicted_next_state(r.state)
    planner.prepare(pred, scene.build_data(pred))
    out = planner.solve_mpc_finish()
    assert out.success in (True, False)
    got = {n: BENCHMARKERS.get(n).count for n in BENCHMARKERS.names()}
    assert got["plan"] == 0 and BENCHMARKERS.ticks == 0
    for name in ("plan.warmstart", "tmpc.assemble", "launch", "select",
                 "fetch_wait", "plan.output"):
        assert got[name] == 1, name
    for name in ("plan.modules", "plan.fill", "guidance"):
        assert got[name] == 2, name  # this tick's and the next one's
    BENCHMARKERS.reset()
