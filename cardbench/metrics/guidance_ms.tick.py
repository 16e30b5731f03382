"""guidance_ms.tick (guidance layer): the program's own timer of the
guidance search (``utils/profiling.py``'s ``BENCHMARKERS["guidance"]``)
summed over the window, per tick, in ms."""


def read(ctx):
    if not ctx.ticks or not ctx.guidance_s:
        return None
    return 1e3 * ctx.guidance_s / ctx.ticks
