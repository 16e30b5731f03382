"""wait_ms.tick (device layer): the host blocked on the device's result,
per tick, in ms: the program's span ``fetch_wait``."""

from cardbench import spans


def read(ctx):
    return spans.ms_per_tick(ctx, spans.seconds(ctx, "fetch_wait"))
