"""What the host launched, or waited for, inside the program's own profiler
spans, for the per-layer readers: the device time of the kernels launched
inside a span, and the host calls inside it that wait for the card. The
profiler gives each device operation the correlation id of the host call
that launched it (``FunctionEvent.id``; each kernel of a CUDA graph the id
of its ``cudaGraphLaunch``). A run with no card traced, or a program
without the span, reads None."""

from __future__ import annotations

import bisect

from .trace import NOT_KERNELS, SPANS, WINDOW_SPAN

LAUNCHES = ("cudaLaunchKernel", "cuLaunch", "cudaGraphLaunch")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
COPIES = ("cudaMemcpy",)


def _inside(ctx, name: str):
    """(window event, the host events on the window's thread that lie
    inside a ``name`` span), or None."""
    from torch.autograd import DeviceType

    if ctx["trace"] is None:
        return None
    cpu = [e for e in ctx["events"] if e.device_type == DeviceType.CPU]
    win = next((e for e in cpu if e.name == WINDOW_SPAN), None)
    if win is None:
        return None
    w0, w1 = win.time_range.start, win.time_range.end
    spans = sorted((e.time_range.start, e.time_range.end) for e in cpu
                   if e.name == name and e.thread == win.thread
                   and e.time_range.end > w0 and e.time_range.start < w1)
    if not spans:
        return None
    starts = [s for s, _ in spans]

    def within(e):
        k = bisect.bisect_right(starts, e.time_range.start) - 1
        return k >= 0 and e.time_range.end <= spans[k][1]

    return win, [e for e in cpu if e.thread == win.thread
                 and e.name != name and within(e)]


def _device(ctx, win):
    from torch.autograd import DeviceType

    w0, w1 = win.time_range.start, win.time_range.end
    return [e for e in ctx["events"] if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in SPANS
            and e.time_range.end > w0 and e.time_range.start < w1]


def launched_inside(ctx, name: str):
    """Device ms a tick of the kernels launched inside the ``name`` spans,
    clipped to the window."""
    found = _inside(ctx, name)
    if found is None:
        return None
    win, host = found
    ids = {e.id for e in host if e.name.startswith(LAUNCHES)}
    w0, w1 = win.time_range.start, win.time_range.end
    us = sum(min(e.time_range.end, w1) - max(e.time_range.start, w0)
             for e in _device(ctx, win)
             if e.id in ids and not e.name.startswith(NOT_KERNELS))
    return us * 1e-3 / ctx["ticks"]


def readbacks_inside(ctx, name: str):
    """Host calls a tick inside the ``name`` spans that wait for the card:
    each synchronise, and each copy whose device copy runs from the device
    to the host."""
    found = _inside(ctx, name)
    if found is None:
        return None
    win, host = found
    to_host = {e.id for e in _device(ctx, win)
               if e.name.startswith("Memcpy DtoH")}
    n = sum(1 for e in host if e.name.startswith(WAITS)
            or (e.name.startswith(COPIES) and e.id in to_host))
    return n / ctx["ticks"]
