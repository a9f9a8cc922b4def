"""Profiling hooks (counterpart of ``ironcub_mpc_tpu/utils/profiling.py``).

:func:`span` names a stage of the program on the profiler's timeline and
costs one test of a Python flag when no profiler records;
:func:`device_trace` writes a ``torch.profiler`` trace as a Chrome trace;
:func:`solves_per_second` is the solves/s of a batched solve. The real-time
driver counts its own deadline overruns (``runtime/native.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

from ..core.types import tree_map


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler records
    on this process, else one shared null context: with no profiler it
    enters no dispatcher op and touches no tensor (a test of the profiler's
    Python flag, so it also stays inert under a CUDA-graph capture)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
    (``trace_<pid>_<ns>.json``) into ``logdir``. The trace carries the
    program's spans (:func:`span`: ``mpc.tick`` and its stages
    ``mpc.prep``, ``mpc.condense``, ``mpc.solve``, ``mpc.finish``;
    ``solve.*`` inside the solve), so the tick's stages show on the
    device's timeline. Yields
    the profiler, so the caller can also read ``key_averages()``."""
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
