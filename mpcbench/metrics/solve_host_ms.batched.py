"""Host ms a tick in the box-QP solve (scale, K⁻¹ refresh, ADMM iterations and
their gates, polish, status): the port's ``mpc.solve`` spans (qp/mpc.py
mpc_tick), clipped to the traced window, over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "mpc.solve")
