"""The readers of the program's own spans and counters: each on a filled
registry (the numbers it should give), on an empty one, and on a program
that records no such span or counter (None, no error)."""

import sys
from types import SimpleNamespace

import pytest

from helpers import ROOT

from cardbench import run

PORT = "oscar_mpc_planner_mr_modification_tpu_torch"
READERS = ("modules_ms.tick", "launch_ms.tick", "wait_ms.tick",
           "select_ms.tick", "uncovered_ms.tick", "useful_planners.tick")


@pytest.fixture
def registry():
    from oscar_mpc_planner_mr_modification_tpu_torch.utils.profiling import (
        BENCHMARKERS)

    BENCHMARKERS.reset()
    yield BENCHMARKERS
    BENCHMARKERS.reset()


def ctx(package=PORT, ticks=4, tick_ms=20.0):
    return SimpleNamespace(config={"package": package}, ticks=ticks,
                           tick_seconds=[tick_ms * 1e-3] * ticks)


def fill(reg, ticks=4):
    """Per tick (seconds, self seconds): a 19 ms plan over 0.5 ms of
    data preparation, the spans under it, 5 planners of which 3 useful."""
    per_tick = {"plan": (19e-3, 0.2e-3), "prep.obstacles": (0.5e-3, 0.5e-3),
                "plan.modules": (5e-3, 2e-3), "guidance": (3e-3, 3e-3),
                "plan.fill": (1e-3, 1e-3), "tmpc.assemble": (1.5e-3, 1.5e-3),
                "launch": (0.5e-3, 0.5e-3), "select": (9e-3, 0.7e-3),
                "fetch_wait": (8.3e-3, 8.3e-3),
                "plan.output": (0.3e-3, 0.3e-3)}
    for _ in range(ticks):
        for name, (total, own) in per_tick.items():
            reg.get(name).record(total, own)
        reg.count("tmpc.planners_solved", 5)
        reg.count("tmpc.planners_useful", 3)
    reg.root_total = ticks * (19e-3 + 0.5e-3)


def test_each_reader_on_a_filled_registry(registry):
    fill(registry)
    c = ctx()
    got = {name: run.reader(ROOT, name)(c) for name in READERS}
    assert got["modules_ms.tick"] == pytest.approx(2.0 + 1.0)
    assert got["launch_ms.tick"] == pytest.approx(1.5 + 0.5)
    assert got["wait_ms.tick"] == pytest.approx(8.3)
    assert got["select_ms.tick"] == pytest.approx(0.7 + 0.3)
    assert got["uncovered_ms.tick"] == pytest.approx(20.0 - 19.5)
    assert got["useful_planners.tick"] == pytest.approx(60.0)


def test_the_basic_tick_has_no_assembly_and_no_planner_counters(registry):
    for name, total in (("plan", 15e-3), ("launch", 1e-3),
                        ("select", 12e-3), ("fetch_wait", 11.9e-3)):
        registry.get(name).record(total, total)
    registry.get("select").self_total = 0.1e-3
    c = ctx(ticks=1)
    assert run.reader(ROOT, "launch_ms.tick")(c) == pytest.approx(1.0)
    assert run.reader(ROOT, "select_ms.tick")(c) == pytest.approx(0.1)
    assert run.reader(ROOT, "useful_planners.tick")(c) is None
    assert run.reader(ROOT, "modules_ms.tick")(c) is None


def test_each_reader_on_an_empty_registry_is_none(registry):
    fill(registry)
    registry.reset()
    for name in READERS:
        assert run.reader(ROOT, name)(ctx()) is None, name


def test_a_program_without_spans_reads_as_none(tmp_path, monkeypatch):
    """A registry of duration lists alone, as a program before the spans
    kept: no reader raises, each returns None."""
    pkg = tmp_path / "program_before_spans"
    (pkg / "utils").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "utils" / "__init__.py").write_text("")
    (pkg / "utils" / "profiling.py").write_text(
        "class Benchmarker:\n"
        "    def __init__(self):\n"
        "        self.durations = [0.002]\n"
        "class Registry:\n"
        "    def get(self, name):\n"
        "        return Benchmarker()\n"
        "BENCHMARKERS = Registry()\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        for name in READERS:
            assert run.reader(ROOT, name)(
                ctx(package="program_before_spans")) is None, name
    finally:
        for mod in [m for m in sys.modules
                    if m.startswith("program_before_spans")]:
            del sys.modules[mod]
