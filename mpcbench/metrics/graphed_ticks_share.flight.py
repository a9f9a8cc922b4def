"""Share of the traced window's closed-loop ticks whose MPC tick ran from
CUDA graphs: the port's ``qp.mpc.mpc_tick.graphed_ticks`` over the
window's ticks, in per cent. None where the program keeps no such
counter."""


def read(ctx):
    n = ctx["counters"].get("qp.mpc.mpc_tick.graphed_ticks")
    return None if n is None else 100.0 * n / ctx["ticks"]
