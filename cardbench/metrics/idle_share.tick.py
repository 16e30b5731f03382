"""idle_share.tick (device layer): per cent of the traced window in which
no operation ran on the device."""

from cardbench.metrics_context import idle_percent


def read(ctx):
    return idle_percent(ctx)
