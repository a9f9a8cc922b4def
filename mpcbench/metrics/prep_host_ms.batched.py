"""Host ms a tick in the tick's prep (reference shift, alphaGravity, linearise,
initial state, throttle pin): the port's ``mpc.prep`` spans (qp/mpc.py
mpc_tick), clipped to the traced window, over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "mpc.prep")
