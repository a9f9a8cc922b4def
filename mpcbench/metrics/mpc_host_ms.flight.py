"""Host ms a tick in the closed loop's MPC tick: the port's ``mpc.tick``
spans (qp/mpc.py mpc_tick), clipped to the traced window, over its
ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "mpc.tick")
