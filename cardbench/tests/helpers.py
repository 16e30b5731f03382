"""What the benchmark's tests share."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_root(tmp, N=6):
    """A checkout-like directory in ``tmp``: this benchmark's files, with
    every configuration cut to horizon ``N`` and the traffic made small, so
    that a whole run fits the CPU. Returns its path."""
    shutil.copytree(ROOT / "cardbench", tmp / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        path = tmp / conf["file"]
        cfg = json.loads(path.read_text())
        cfg["overrides"] = {"N": N}
        cfg["reference"]["N"] = N
        path.write_text(json.dumps(cfg))
    for path in (tmp / "cardbench" / "workloads").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(warmup_ticks=2, warmup_cycles=1, robots=4, input_sets=2)
        t["check"] = {"sample_ticks": 3, "sample_robots": 4}
        path.write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
