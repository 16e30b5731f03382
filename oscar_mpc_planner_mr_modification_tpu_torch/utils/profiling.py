"""Profiling: the program's spans and counters, in one registry.

Counterpart of the JAX package's ``utils/profiling.py``. ``span(name)``
times one phase of the host path inside the method that does the work and
records it into ``BENCHMARKERS[name]``: the count, the total, the self
time (the duration less what its child spans cover, one stack of open
spans per thread) and the most recent durations. ``BENCHMARKERS.count``
keeps counters beside them; ``BENCHMARKERS.reset()`` clears both.

Ticks: the ``plan`` span (``Planner.solve_mpc``) starts no new tick until
it ends, so a span's tick is the number of ``plan`` spans ended when it
began: the data preparation before a plan and the plan itself share one
id.

Device time comes from CUDA events and ``torch.profiler``. With
:func:`profiler_ranges` on, every span also opens a ``torch.profiler``
range of its name, so a trace holds the program's phases on the device's
clock; a root span's range carries its tick as its argument (shown as the
range's concrete input where the profiler records shapes). Off by default:
then a span costs two ``perf_counter`` calls, a push and a pop, one flag
check and its record (1.5-1.8 us on an H100 machine's host).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

import torch

#: Durations each ``Benchmarker`` keeps for ``last``, ``mean`` and
#: percentiles: 20 Hz for ~7 minutes. Count and totals are exact.
WINDOW = 8192


class Benchmarker:
    """One name's spans: exact ``count``, ``total`` and ``self_total``
    (seconds) and the ``durations`` of the last ``WINDOW``."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def record(self, duration: float, self_time: float) -> None:
        self.count += 1
        self.total += duration
        self.self_total += self_time
        self.durations.append(duration)

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
        self.count = 0
        self.total = 0.0
        self.self_total = 0.0
        self.durations = deque(maxlen=WINDOW)


class _BenchmarkerRegistry:
    """Every ``Benchmarker`` and counter by name; ``ticks`` plans ended and
    ``root_total`` seconds in spans opened with no span open, since the
    last :meth:`reset`."""

    def __init__(self):
        self._benchmarkers: Dict[str, Benchmarker] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.ranges = False  # profiler_ranges
        self.ticks = 0
        self.root_total = 0.0

    def get(self, name: str) -> Benchmarker:
        b = self._benchmarkers.get(name)
        if b is None:
            with self._lock:
                b = self._benchmarkers.setdefault(name, Benchmarker(name))
        return b

    def names(self):
        return list(self._benchmarkers)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def _record(self, name, duration, self_time, root, ends_tick) -> None:
        b = self._benchmarkers.get(name) or self.get(name)
        with self._lock:
            b.record(duration, self_time)
            if root:
                self.root_total += duration
            if ends_tick:
                self.ticks += 1

    def reset(self) -> None:
        with self._lock:
            for b in self._benchmarkers.values():
                b.reset()
            self._counters.clear()
            self.ticks = 0
            self.root_total = 0.0


BENCHMARKERS = _BenchmarkerRegistry()


def profiler_ranges(on: bool) -> bool:
    """Open a ``torch.profiler`` range with every span from now on (or
    stop); returns the previous setting."""
    before = BENCHMARKERS.ranges
    BENCHMARKERS.ranges = bool(on)
    return before


class _Open(threading.local):
    def __init__(self):
        self.spans = []


_OPEN = _Open()


class span:
    """``with span(name):`` times the block into ``BENCHMARKERS[name]``;
    ``span("plan", tick=True)`` ends a tick when it ends. After the block,
    ``duration`` holds its seconds."""

    __slots__ = ("name", "ends_tick", "t0", "child", "duration", "_range")

    def __init__(self, name: str, tick: bool = False):
        self.name = name
        self.ends_tick = tick
        self.child = 0.0
        self.duration = 0.0
        self._range = None

    def __enter__(self) -> "span":
        open_spans = _OPEN.spans
        if BENCHMARKERS.ranges:
            self._range = (torch.autograd._record_function_with_args_enter(
                self.name, BENCHMARKERS.ticks) if not open_spans else
                torch.autograd._record_function_with_args_enter(self.name))
        open_spans.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.duration = time.perf_counter() - self.t0
        open_spans = _OPEN.spans
        open_spans.pop()
        if open_spans:
            open_spans[-1].child += self.duration
        if self._range is not None:
            torch.autograd._record_function_with_args_exit(self._range)
        BENCHMARKERS._record(self.name, self.duration,
                             self.duration - self.child, not open_spans,
                             self.ends_tick)
        return False
