"""select_ms.tick (tmpc dispatch layer): the readback's decoding, the
selection and the plan's extraction, per tick, in ms: the self time of the
program's span ``select`` (the wait inside it, ``fetch_wait``, left out)
and the span ``plan.output``."""

from cardbench import spans


def read(ctx):
    select = spans.seconds(ctx, "select", own=True)
    if select is None:
        return None
    return spans.ms_per_tick(
        ctx, select + (spans.seconds(ctx, "plan.output") or 0.0))
