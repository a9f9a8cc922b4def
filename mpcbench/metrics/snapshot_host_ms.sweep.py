"""Host ms a tick in the sweep's snapshot of every lane (the plant's
sensors and ``compute_snapshot``): the port's ``loop.snapshot`` spans
(runtime/loop.py ClosedLoop.tick; a retry's too), clipped to the traced
window, over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "loop.snapshot")
