"""What the per-layer readers in ``mpcbench/metrics/`` share.

A reader takes the traced run's context and returns its number, or None
where the trace holds nothing it can read: the harness then leaves the
metric out of the line. The context (a dict):

- ``ticks``: ticks in the traced window (all passes), ``lanes``: lanes;
- ``trace``: a :class:`mpcbench.core.trace.Trace` (window, busy time,
  kernels, the heaviest operations and idle gaps), or None where no card
  was traced;
- ``events``: the profiler's raw events (``prof.events()``: host spans and
  operations, device kernels, copies, memory), for a reader that needs
  more than ``trace`` holds;
- ``counters``: how far each counter the program keeps moved over the
  window, keyed ``<module>.<function>.<attribute>``
  (``qp.condensed.batch_any.syncs``, ``ops.kernels.woodbury_ns.launches``;
  ``mpcbench.core.port.counters``);
- ``calls``: {kernel wrapper: [its arguments a call]} over the window:
  positional tensors' shapes under ``shapes``, keywords by name
  (``mpcbench.core.port.instrument``);
- ``memory_peak_bytes``: the device's peak allocation up to the window's
  end, or None without a card;
- ``roofline``: ``mpcbench.core.spec.roofline``, ``peaks``: the peaks.
"""

from __future__ import annotations


def kernels_per_tick(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["ticks"]


def readbacks_per_tick(ctx):
    n = ctx["counters"].get("qp.condensed.batch_any.syncs")
    return None if n is None else n / ctx["ticks"]


def idle_share(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_share(ctx, kernel: str):
    """The least time the calls of ``kernel`` in the window could take on the
    card (the larger of operations over the float32 peak and bytes over the
    HBM peak, call by call, summed) over the device time of its kernels, in
    per cent. None where it made no call or no kernel of it ran."""
    tr, calls = ctx["trace"], ctx["calls"].get(kernel)
    if tr is None or not calls:
        return None
    mod = ctx["roofline"](kernel)
    busy = sum(t for n, t in tr.kernels
               if any(k in n for k in mod.KERNEL_NAMES))
    if busy <= 0:
        return None
    pk = ctx["peaks"]
    least = 0.0
    for call in calls:
        try:
            ops, nbytes = mod.work(call)
        except (KeyError, IndexError):  # a call the count cannot read
            return None
        least += max(ops / pk["fp32_flops_per_s"],
                     nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least / busy
