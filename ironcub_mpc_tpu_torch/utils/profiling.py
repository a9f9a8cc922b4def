"""Profiling and real-time instrumentation (counterpart of
``ironcub_mpc_tpu/utils/profiling.py``).

The reference instruments the control loop with wall-clock timing around
update+solve, a rolling average print every 200 ticks and a deadline-overrun
warning (variable_sampling_mpc.py:110-123). This module provides the same
counters plus a device trace (``torch.profiler``, written as a Chrome trace)
and solves/s accounting for batched runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import List

import torch

from ..core.types import tree_map


class Timer:
    """Wall-clock timer with rolling statistics (`time_MPC` equivalent)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.samples: List[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        return False

    @property
    def last(self) -> float:
        return self.samples[-1]

    def rolling_mean(self) -> float:
        recent = self.samples[-self.window:]
        return sum(recent) / max(len(recent), 1)

    def series(self):
        import numpy as np

        return np.asarray(self.samples)


class DeadlineMonitor:
    """Deadline-overrun accounting (variable_sampling_mpc.py:122-123)."""

    def __init__(self, period: float, verbose: bool = True):
        self.period = period
        self.verbose = verbose
        self.overruns = 0
        self.worst = 0.0

    def check(self, elapsed: float) -> bool:
        over = elapsed > self.period
        if over:
            self.overruns += 1
            self.worst = max(self.worst, elapsed - self.period)
            if self.verbose:
                print(f"MPC exceeded the period by: {elapsed - self.period:.6f}")
        return over


def _cuda_devices(tree) -> set:
    """The CUDA devices that hold a tensor of ``tree``: named tuples walked
    by :func:`tree_map`, plain tuples and lists item by item."""
    found = set()

    def visit(leaf):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                found.add(leaf.device)
        elif isinstance(leaf, (tuple, list)):
            for item in leaf:
                tree_map(visit, item)
        return leaf

    tree_map(visit, tree)
    return found


def _wait_for(out):
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def solves_per_second(batch: int, iters: int, fn, *args) -> float:
    """Throughput of a batched solve: one warm-up call, then ``iters``
    calls timed up to the moment every card holding the output is done."""
    out = fn(*args)
    _wait_for(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait_for(out)
    return batch * iters / (time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the body — host activity, and the card's
    where one is present — written on exit as a Chrome trace JSON
    (``trace_<pid>_<ns>.json``) into ``logdir``. Yields the profiler, so
    the caller can also read ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
