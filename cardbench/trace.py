"""From a ``torch.profiler`` trace of the measured window to what the
per-layer metrics read: every device operation (kernels, copies, fills)
with its start and end, the harness's own host spans (``record_function``
ranges named ``cardbench.*``), the device's busy time (the union of its
operations), and the breakdown of the result line (the device operations
that took most time, the longest idle gaps by the host span that held
them). Times are seconds on the profiler's clock."""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

SPAN_PREFIX = "cardbench."


class Trace(NamedTuple):
    ops: list  # [(name, start, end)] on the device, sorted by start
    spans: list  # [(name, start, end)] of the harness, sorted by start
    window: tuple  # (start, end)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]


def from_profiler(prof, window_span="cardbench.window") -> Trace:
    from torch.autograd import DeviceType

    ops, spans = [], []
    for ev in prof.events():
        t0, t1 = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name.startswith(SPAN_PREFIX):
            # a host span; its copy on the device's timeline is no work
            if ev.device_type != DeviceType.CUDA:
                spans.append((ev.name, t0, t1))
        elif ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, t0, t1))
    ops.sort(key=lambda o: o[1])
    spans.sort(key=lambda s: s[1])
    win = [s for s in spans if s[0] == window_span]
    if not win:
        raise RuntimeError(f"the trace holds no {window_span} span")
    return Trace(ops, spans, (win[0][1], win[0][2]))


def union(intervals, lo=-np.inf, hi=np.inf):
    """Merged [start, end) intervals clipped to [lo, hi]."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(trace: Trace, lo=None, hi=None) -> float:
    lo = trace.window[0] if lo is None else lo
    hi = trace.window[1] if hi is None else hi
    return float(sum(b - a for a, b in union(
        [(o[1], o[2]) for o in trace.ops], lo, hi)))


class Busy:
    """The device's busy intervals, for the busy time inside many
    intervals: ``Busy(trace).between(a, b)``."""

    def __init__(self, trace: Trace):
        iv = np.array(union([(o[1], o[2]) for o in trace.ops]) or
                      np.zeros((0, 2)))
        self.start, self.end = iv[:, 0], iv[:, 1]
        self.cum = np.concatenate([[0.0], np.cumsum(self.end - self.start)])

    def _upto(self, t):
        """Busy time before t."""
        i = int(np.searchsorted(self.start, t, side="right"))
        if i == 0:
            return 0.0
        return float(self.cum[i - 1] + min(t, self.end[i - 1])
                     - self.start[i - 1])

    def between(self, a, b):
        return self._upto(b) - self._upto(a)


def kernel_times(trace: Trace, pattern) -> list:
    """Durations (s) of the device operations in the window whose name
    matches ``pattern``."""
    rx = re.compile(pattern)
    lo, hi = trace.window
    return [t1 - t0 for name, t0, t1 in trace.ops
            if rx.search(name) and t0 >= lo and t1 <= hi]


def short(name, width=120):
    """A device operation's name without its argument list."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name[:width]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:width]


def breakdown(trace: Trace, top=10) -> dict:
    lo, hi = trace.window
    by_name = {}
    for name, t0, t1 in trace.ops:
        if t0 >= lo and t1 <= hi:
            key = short(name)
            by_name[key] = by_name.get(key, 0.0) + (t1 - t0)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(o[1], o[2]) for o in trace.ops], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    names = {}
    for name, s0, s1 in trace.spans:
        if name != "cardbench.window":
            names.setdefault(name[len(SPAN_PREFIX):], []).append((s0, s1))
    table = {k: np.array(v) for k, v in names.items()}
    idle = {}
    for a, b in gaps:
        mid, key, width = 0.5 * (a + b), "outside a span", np.inf
        for name, iv in table.items():
            i = int(np.searchsorted(iv[:, 0], mid)) - 1
            if i >= 0 and iv[i, 1] > mid and iv[i, 1] - iv[i, 0] < width:
                key, width = name, iv[i, 1] - iv[i, 0]
        idle[key] = idle.get(key, 0.0) + (b - a)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle_gaps]}
