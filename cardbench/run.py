"""Run one cell of the benchmark once:

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up by name in
``BENCHMARK.json``; its configuration file, its traffic file
(``cardbench/workloads/<traffic>.json``, whose ``driver`` names the loop in
``cardbench/drivers/``), its limits (``cardbench/limits/<cell>.json``) and
the readers of its per-layer metrics (``cardbench/metrics/<metric>.py``)
are found by name. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics, or with ``--trace 1`` the per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit. Without a CUDA device, or with fewer devices than the
cell asks for, it prints no result and exits with code 2."""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one thread per math library: the planner's host work is many small
# operations, and idle pool threads add jitter to the tick's tail
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: The benchmark's own directory in a checkout.
OWN = "cardbench"
#: Top-level modules that must not be loaded in a measured process.
FORBIDDEN = ("jax", "jaxlib", "flax", "oscar_mpc_planner_mr_modification_tpu")


def environment(root: Path):
    """Fixed cache directories inside the checkout, and no JAX in libraries
    that would load it by themselves."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "cardbench_cache" / sub)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest(root: Path):
    return load_json(root / "BENCHMARK.json")


def cell_files(root: Path, bench: dict, name: str):
    """(cell, configuration entry, configuration file, traffic file,
    limits) of the cell named ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"cardbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    own = root / OWN
    return (cell, conf, load_json(root / conf["file"]),
            load_json(own / "workloads" / f"{cell['traffic']}.json"),
            load_json(own / "limits" / f"{name}.json"))


def per_layer_metrics(bench: dict, cell: dict):
    """The per-layer metrics this cell reports: those listing it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def end_to_end_metrics(bench: dict, cell: dict):
    return [m for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(root: Path, name: str):
    """The ``read(context)`` of ``cardbench/metrics/<name>.py``."""
    path = root / OWN / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    environment(root)
    bench = manifest(root)
    cell, conf, config, traffic, limits = cell_files(root, bench,
                                                     args.workload)

    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("cardbench: no CUDA device; nothing is measured on the CPU",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"cardbench: {cell['name']} needs {cell['chips']} devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"
    sys.path.insert(0, str(root))
    from .drivers.common import Job

    driver = importlib.import_module(f"cardbench.drivers.{traffic['driver']}")
    job = Job(cell, config, traffic, args.seed, args.seconds,
              bool(args.trace), device, T_START, limits)
    out = driver.run(job)

    found = forbidden_loaded()
    if found:
        print(f"cardbench: the measured process loaded {found}",
              file=sys.stderr)
        return 3

    from . import metrics_context

    metrics, extra = {}, {}
    if args.trace:
        ctx = metrics_context.build(job, out)
        for m in per_layer_metrics(bench, cell):
            value = reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        kernels = sorted({n for n, _, _ in ctx.trace.ops
                          if "at::native" not in n and not n.startswith("Mem")})
        print("cardbench: kernels in the trace: "
              + " | ".join(k[:160] for k in kernels), file=sys.stderr)
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in end_to_end_metrics(bench, cell):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    correct = all(v <= lim for v, lim in out.checks.values())
    for name, (v, lim) in out.checks.items():
        print(f"cardbench: {name} {v!r} limit {lim!r}", file=sys.stderr)
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": out.memory_peak_bytes, **extra}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device_info}
    if args.trace:
        line["breakdown"] = ctx.breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in out.checks.items()}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
