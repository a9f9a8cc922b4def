"""Recovery retries a sweep tick: the port's
``parallel.monte_carlo._sweep_tick.retries`` (ticks re-run because a lane's
solve failed) over its ``.ticks`` over the traced window. None where the
program keeps no such counter or ran no sweep tick."""


def read(ctx):
    c = ctx["counters"]
    n = c.get("parallel.monte_carlo._sweep_tick.ticks")
    retries = c.get("parallel.monte_carlo._sweep_tick.retries")
    if not n or retries is None:
        return None
    return retries / n
