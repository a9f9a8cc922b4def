"""Host ms a tick in the sweep's five 1 kHz plant substeps of every lane:
the port's ``loop.plant`` spans (runtime/loop.py ClosedLoop.tick; a retry's
too), clipped to the traced window, over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "loop.plant")
