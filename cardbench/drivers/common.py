"""What the drivers share: the program's modules, the check that the
program runs the configuration file's settings, launch counters, the
profiler around a window, and the numbers of one run."""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import NamedTuple


class Job(NamedTuple):
    cell: dict  # the workload entry of BENCHMARK.json
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda"; "cpu" only in the CPU tests
    t_start: float  # perf_counter at the process's start
    limits: dict  # the cell's limit of each number compared


class Outcome(NamedTuple):
    attempted: int
    failed: int
    end_to_end: dict  # name -> value
    setup_s: float
    memory_peak_bytes: int
    context: dict  # what the per-layer readers read
    checks: dict  # name -> (value, limit)


def module(config, name):
    return importlib.import_module(f"{config['package']}.{name}")


def sqp_of(config, pkg_sqp):
    """The program's SQP config of the configuration file's ``sqp``."""
    s = config["reference"]["sqp"]
    return pkg_sqp.SQPConfig(
        n_sqp=int(s["n_sqp"]), n_qp_iter=int(s["n_qp_iter"]),
        mu_min=float(s["mu_min"]), reg_eps=float(s["reg_eps"]),
        w_max=float(s["w_max"]), regularization=s["regularization"],
        res_eq_tol=float(s["res_eq_tol"]),
        merit_eq_weight=float(s["merit_eq_weight"]),
        track_best=bool(s["track_best"]))


def require_same(what, got, want):
    """Stop the run where the program does not run the configuration file's
    value."""
    if got != want:
        raise SystemExit(f"cardbench: the program runs {what} = {got!r}, the "
                         f"configuration file says {want!r}")


def launches(config):
    """Every kernel wrapper's launch count so far."""
    return module(config, "tools.common").launch_counts()


def launches_between(before, after):
    if before is None or after is None:
        return None
    return sum(after[k] - before[k] for k in after)


def sync(device):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(enabled):
    """A ``torch.profiler`` trace over the block (CPU and CUDA
    activities), or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        yield prof


def span(enabled, name):
    """A named host span in the trace (``cardbench.<name>``), or nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"cardbench.{name}")


def traced(enabled, name, fn):
    """``fn`` wrapped in a host span when tracing."""
    if not enabled:
        return fn

    def wrapper(*a, **k):
        with span(True, name):
            return fn(*a, **k)

    return wrapper


def memory_peak(device):
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(0))


def clock():
    return time.perf_counter()
