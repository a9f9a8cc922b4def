"""Host ms a tick in the closed loop's five 1 kHz plant substeps: the
port's ``loop.plant`` spans (runtime/loop.py ClosedLoop.tick), clipped to
the traced window, over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "loop.plant")
