"""ADMM iterations launched a tick for the batch: the port's
``qp.condensed.solve.iterations`` (each segment call's length, skipped chunks
not counted) over the traced window's ticks."""


def read(ctx):
    n = ctx["counters"].get("qp.condensed.solve.iterations")
    return None if n is None else n / ctx["ticks"]
