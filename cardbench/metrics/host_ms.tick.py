"""host_ms.tick (planner layer): per tick, the wall time less the device's
busy time inside it (torch.profiler), averaged over the window, in ms."""

from cardbench.metrics_context import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx)
