"""Host ms a tick in the sweep's own work around the closed loop's ticks:
the port's ``sweep.gate`` (the recovery predicate's batch-wide read-back),
``sweep.retry`` (the re-run tick, where one ran) and ``sweep.stats`` (the
accumulators) spans (parallel/monte_carlo.py ``_sweep_tick``), clipped to
the traced window, over its ticks. None where no card was traced or the
program has no such span."""
from mpcbench.core.spans import host_ms_per_tick

SPANS = ("sweep.gate", "sweep.retry", "sweep.stats")


def read(ctx):
    found = [v for v in (host_ms_per_tick(ctx, s) for s in SPANS)
             if v is not None]
    return sum(found) if found else None
