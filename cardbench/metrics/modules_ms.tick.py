"""modules_ms.tick (planner layer): the modules' updates and parameter fill
less the guidance search inside them, per tick, in ms: the self time of
the program's spans ``plan.modules`` (``ModuleManager.update_all``) and
``plan.fill`` (``ModuleManager.set_all_parameters``)."""

from cardbench import spans


def read(ctx):
    modules = spans.seconds(ctx, "plan.modules", own=True)
    fill = spans.seconds(ctx, "plan.fill", own=True)
    if modules is None or fill is None:
        return None
    return spans.ms_per_tick(ctx, modules + fill)
