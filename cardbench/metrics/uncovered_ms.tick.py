"""uncovered_ms.tick (planner layer): the tick time that no span of the
program explains, in ms: the mean tick's wall time less the program's root
spans per tick (``plan``, the data preparation's ``prep.obstacles`` and
``prep.prediction``)."""

import numpy as np

from cardbench import spans


def read(ctx):
    if spans.seconds(ctx, "plan") is None or not ctx.ticks:
        return None
    root = spans.registry(ctx).root_total
    return 1e3 * (float(np.mean(ctx.tick_seconds)) - root / ctx.ticks)
