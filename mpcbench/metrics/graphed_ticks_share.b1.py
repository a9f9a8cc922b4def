"""Share of the traced window's ticks that ran from CUDA graphs: the port's
``qp.mpc.mpc_tick.graphed_ticks`` over the window's ticks, in per cent
(qp/mpc.py mpc_tick: a condensed tick on the card with per-lane decisions).
None where the program keeps no such counter."""


def read(ctx):
    n = ctx["counters"].get("qp.mpc.mpc_tick.graphed_ticks")
    return None if n is None else 100.0 * n / ctx["ticks"]
