"""launches_per_plan.tick (tmpc dispatch / solver layer): kernel launches
the program counted over the window (``tools/common.py::launch_counts``),
per tick."""

from cardbench.metrics_context import per_plan


def read(ctx):
    return per_plan(ctx, ctx.launches)
