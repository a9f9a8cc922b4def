"""Reads a ``torch.profiler`` trace of the traced window into what the
per-layer readers and the result's ``breakdown`` need.

The window is the host span ``mpcbench.window`` the driver records around
the traced ticks. On the device every operation counts as busy time
(kernels, copies, fills; not the copies of the host's spans that the
profiler draws on the device's timeline), taken as the union of their
intervals inside the window: a sum would count twice where streams
overlap. Kernels are the device events
that are neither a copy nor a fill. An idle gap is named after the
innermost host operation of the window's thread that was running at its
middle, and the gaps' seconds are summed by that name.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

WINDOW_SPAN = "mpcbench.window"
# the harness's host spans, which the profiler also draws on the device's
# timeline; they are no device work
SPANS = (WINDOW_SPAN, "mpc_tick", "commands", "pass_sync")
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10


class Trace(NamedTuple):
    start_us: float      # the window on the profiler's clock
    end_us: float
    window_s: float
    busy_s: float
    kernels: list        # [(name, seconds)], one entry a launch
    device_ops: list     # [[name, seconds]] the heaviest, summed by name
    idle_gaps: list      # [[host op, seconds]] the longest, summed by op


def _union(spans):
    """Sorted disjoint intervals covering ``spans``."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, points):
    """The innermost host event open at each of ``points`` (sorted), from
    ``host`` [(start, end, name)] sorted by start, properly nested."""
    names, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            ev = host[i]
            while stack and stack[-1][1] < ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else "no host op")
    return names


def read(events, spans=(), short: int = 96) -> Trace:
    """The window's device time and idle gaps from the profiler's
    ``events()``; times in seconds. ``spans`` names host spans besides the
    harness's own (the port's wrapped functions)."""
    from torch.autograd import DeviceType

    spans = [e for e in events if e.name == WINDOW_SPAN
             and e.device_type == DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    win = spans[0]
    w0, w1 = win.time_range.start, win.time_range.end
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in SPANS and e.name not in spans
              and e.time_range.end > w0 and e.time_range.start < w1]
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device]
    busy = _union((s, e) for s, e, _ in device)
    kernels = [(n, (e - s) * 1e-6) for s, e, n in device
               if not n.startswith(NOT_KERNELS)]

    by_name = defaultdict(float)
    for s, e, n in device:
        by_name[n[:short]] += (e - s) * 1e-6
    device_ops = sorted(([n, t] for n, t in by_name.items()),
                        key=lambda x: -x[1])[:TOP]

    gaps, reach = [], w0
    for s, e in busy:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if w1 > reach:
        gaps.append((reach, w1))
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == DeviceType.CPU
                  and e.thread == win.thread and e is not win
                  and e.time_range.end > w0 and e.time_range.start < w1)
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    idle = defaultdict(float)
    for (_, length), name in zip(mids, _innermost(host, [m for m, _ in mids])):
        idle[name[:short]] += length * 1e-6
    idle_gaps = sorted(([n, t] for n, t in idle.items()),
                       key=lambda x: -x[1])[:TOP]
    return Trace(start_us=w0, end_us=w1, window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 kernels=kernels, device_ops=device_ops, idle_gaps=idle_gaps)
