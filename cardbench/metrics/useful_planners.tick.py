"""useful_planners.tick (tmpc dispatch layer): per cent of the planners
solved on the device that were enabled (a guidance trajectory or the
unguided planner) and succeeded: the program's counters
``tmpc.planners_useful`` over ``tmpc.planners_solved``."""

from cardbench import spans


def read(ctx):
    solved = spans.counter(ctx, "tmpc.planners_solved")
    if not solved:
        return None
    return 100.0 * spans.counter(ctx, "tmpc.planners_useful") / solved
