"""launches_per_plan.fleet (tmpc dispatch layer): kernel launches the
program counted over the window, per robot plan of the batched step."""

from cardbench.metrics_context import per_plan


def read(ctx):
    return per_plan(ctx, ctx.launches)
