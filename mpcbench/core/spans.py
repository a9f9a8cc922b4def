"""Host time in the program's own profiler spans (``utils/profiling.span``
of the port: ``mpc.prep``, ``mpc.condense``, ``mpc.solve``,
``mpc.finish``, ``solve.*``), for the per-layer readers. A program without
such spans, or a run with no card traced, reads None."""

from __future__ import annotations

from .trace import WINDOW_SPAN


def host_ms_per_tick(ctx, name: str):
    """The host durations of the CPU events named ``name`` on the traced
    window's thread, clipped to the window, summed in ms over the window's
    ticks; None where no card was traced or no such span ran."""
    from torch.autograd import DeviceType

    if ctx["trace"] is None:
        return None
    cpu = [e for e in ctx["events"] if e.device_type == DeviceType.CPU]
    win = next((e for e in cpu if e.name == WINDOW_SPAN), None)
    if win is None:
        return None
    w0, w1 = win.time_range.start, win.time_range.end
    us = [min(e.time_range.end, w1) - max(e.time_range.start, w0)
          for e in cpu if e.name == name and e.thread == win.thread
          and e.time_range.end > w0 and e.time_range.start < w1]
    if not us:
        return None
    return sum(us) * 1e-3 / ctx["ticks"]
