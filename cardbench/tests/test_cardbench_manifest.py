"""BENCHMARK.json and the files it names: the shape the harness reads, and
that a configuration, a cell or a per-layer metric is added as new files
and entries alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from helpers import ROOT, manifest

from cardbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["cardbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_entry_keys():
    b = manifest()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cardbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for x in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files_and_reports_what_it_must():
    b = manifest()
    for cell in b["workloads"]:
        _, _, config, traffic, limits = run.cell_files(ROOT, b, cell["name"])
        assert (ROOT / "cardbench" / "drivers"
                / f"{traffic['driver']}.py").is_file()
        assert set(limits) >= {"solve_gap", "cost_gap", "select_errors"}
        e2e = {m["name"] for m in run.end_to_end_metrics(b, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.per_layer_metrics(b, cell)
        assert layer
        for m in layer:
            assert callable(run.reader(ROOT, m["name"]))
            assert cell["name"] in m["workloads"]
            assert m["moves"] in e2e
        assert config["package"].endswith("_torch")


def test_each_configuration_is_used_and_has_its_own_file():
    b = manifest()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))


def test_a_cell_config_and_metric_are_added_as_files(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric: new
    files plus entries in BENCHMARK.json, no edit of a file that exists."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "cardbench").rglob("*")
              if p.is_file()}
    b = manifest()
    own = tmp_path / "cardbench"
    cfg = json.loads((own / "configs" / "jackal_tmpc.json").read_text())
    cfg["reference"]["n_paths"] = 8
    (own / "configs" / "jackal_tmpc8.json").write_text(json.dumps(cfg))
    t = json.loads((own / "workloads" / "crossing_pedestrians.json")
                   .read_text())
    t["pedestrians"]["speed"] = [1.2, 1.6]
    (own / "workloads" / "fast_crossing.json").write_text(json.dumps(t))
    (own / "limits" / "tmpc8_tick.json").write_text(
        (own / "limits" / "tmpc_tick.json").read_text())
    (own / "metrics" / "ticks_seen.tick.py").write_text(
        "def read(ctx):\n    return float(ctx.ticks)\n")
    b["configs"].append(dict(b["configs"][0], name="jackal_tmpc8",
                             file="cardbench/configs/jackal_tmpc8.json"))
    b["workloads"].append({"name": "tmpc8_tick", "config": "jackal_tmpc8",
                           "traffic": "fast_crossing", "chips": 1,
                           "why": "eight guided planners"})
    b["per_layer"].append({"name": "ticks_seen.tick", "unit": "ticks",
                           "better": "higher", "source": "program_counter",
                           "layer": "planner", "moves": "tick_p95_ms",
                           "workloads": ["tmpc8_tick"]})
    cell, conf, config, traffic, limits = run.cell_files(tmp_path, b,
                                                         "tmpc8_tick")
    assert config["reference"]["n_paths"] == 8
    assert traffic["pedestrians"]["speed"] == [1.2, 1.6]
    names = [m["name"] for m in run.per_layer_metrics(b, cell)]
    assert names == ["ticks_seen.tick"]
    ctx = type("Ctx", (), {"ticks": 7})()
    assert run.reader(tmp_path, "ticks_seen.tick")(ctx) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_no_result_without_a_card_or_without_the_program(tmp_path,
                                                         monkeypatch):
    """The measuring command exits with code 2 and prints nothing where it
    finds no CUDA device; the CPU never stands in for the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", "tmpc_tick", "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) == 2


def test_unknown_cell_stops(tmp_path):
    with pytest.raises(SystemExit):
        run.cell_files(Path(ROOT), manifest(), "no_such_cell")
