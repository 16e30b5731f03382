"""launch_ms.tick (tmpc dispatch layer): the host's work from the planners'
inputs to the launches enqueued, per tick, in ms: the program's spans
``tmpc.assemble`` (the T-MPC optimizer's inputs, where the tick has them)
and ``launch`` (staging, the upload and the launches)."""

from cardbench import spans


def read(ctx):
    launch = spans.seconds(ctx, "launch")
    if launch is None:
        return None
    return spans.ms_per_tick(
        ctx, launch + (spans.seconds(ctx, "tmpc.assemble") or 0.0))
