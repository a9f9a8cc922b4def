"""Host ms a tick in the sweep's batched MPC tick: the port's ``mpc.tick``
spans (qp/mpc.py mpc_tick; a retry's too), clipped to the traced window,
over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "mpc.tick")
