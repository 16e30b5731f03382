"""Profiling: named benchmarkers and chrome-trace instrumentation.

Counterpart of the JAX package's ``utils/profiling.py``: ``BENCHMARKERS``
holds named wall-clock timers (the planner times ``planning`` and
``optimization`` with them, the T-MPC optimizer the guidance search as
``guidance``), and ``profile_scope`` writes chrome://tracing events. They
time host-side orchestration; device time comes from CUDA events and
``torch.profiler``.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class Benchmarker:
    def __init__(self, name: str):
        self.name = name
        self._start: Optional[float] = None
        self.durations: List[float] = []

    def start(self) -> None:
        self._start = time.perf_counter()

    def is_running(self) -> bool:
        return self._start is not None

    def cancel(self) -> None:
        self._start = None

    def stop(self) -> float:
        if self._start is None:
            return 0.0
        dur = time.perf_counter() - self._start
        self.durations.append(dur)
        self._start = None
        return dur

    @property
    def last(self) -> float:
        return self.durations[-1] if self.durations else 0.0

    @property
    def mean(self) -> float:
        return sum(self.durations) / len(self.durations) if self.durations else 0.0

    def percentile(self, q: float) -> float:
        if not self.durations:
            return 0.0
        data = sorted(self.durations)
        idx = min(int(q / 100.0 * len(data)), len(data) - 1)
        return data[idx]

    def reset(self) -> None:
        self.durations = []
        self._start = None


class _BenchmarkerRegistry:
    def __init__(self):
        self._benchmarkers: Dict[str, Benchmarker] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> Benchmarker:
        with self._lock:
            if name not in self._benchmarkers:
                self._benchmarkers[name] = Benchmarker(name)
            return self._benchmarkers[name]

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"mean": b.mean, "last": b.last, "p99": b.percentile(99),
                   "count": len(b.durations)}
            for name, b in self._benchmarkers.items()
        }

    def reset(self) -> None:
        for b in self._benchmarkers.values():
            b.reset()


BENCHMARKERS = _BenchmarkerRegistry()


class Instrumentor:
    """A chrome://tracing JSON session."""

    _instance: Optional["Instrumentor"] = None

    def __init__(self):
        self._events: List[dict] = []
        self._session: Optional[str] = None
        self._path: Optional[str] = None
        self._lock = threading.Lock()

    @classmethod
    def get(cls) -> "Instrumentor":
        if cls._instance is None:
            cls._instance = Instrumentor()
        return cls._instance

    def begin_session(self, name: str, filepath: str) -> None:
        self._session = name
        self._path = filepath
        self._events = []

    def write_event(self, name: str, start_us: float, dur_us: float) -> None:
        if self._session is None:
            return
        with self._lock:
            self._events.append({
                "name": name, "cat": "scope", "ph": "X", "ts": start_us,
                "dur": dur_us, "pid": 0,
                "tid": threading.get_ident() % 100000,
            })

    def end_session(self) -> None:
        if self._session is None or self._path is None:
            return
        with open(self._path, "w") as f:
            json.dump({"traceEvents": self._events}, f)
        self._session = None


@contextmanager
def profile_scope(name: str):
    """Time the enclosed block as one trace event."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        Instrumentor.get().write_event(name, t0 * 1e6, (t1 - t0) * 1e6)
