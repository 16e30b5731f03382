"""What the readers of the program's own spans and counters share: the
port's registry (``utils/profiling.py``'s ``BENCHMARKERS``) as the window
left it, since the tick driver resets it at the window's start. A span
that never ran in the window, or a program that records no such span or
counter, reads as nothing, and the reader returns None."""

from __future__ import annotations

from .drivers import common


def registry(ctx):
    return common.module(ctx.config, "utils.profiling").BENCHMARKERS


def seconds(ctx, name, own=False):
    """Seconds in span ``name`` over the window (with ``own``, its self
    time: less what its child spans cover), or None where it never ran."""
    b = registry(ctx).get(name)
    if not getattr(b, "count", 0):
        return None
    return b.self_total if own else b.total


def counter(ctx, name):
    reg = registry(ctx)
    return reg.counter(name) if hasattr(reg, "counter") else 0


def ms_per_tick(ctx, value):
    if value is None or not ctx.ticks:
        return None
    return 1e3 * value / ctx.ticks
