"""One run of one cell: set-up, the measured (or traced) window, the check.

The cell's traffic mix names the loop that drives it
(``mpcbench/loops/<loop>.py``; ``loops/__init__.py`` sets out what a loop
provides): the loop's set-up builds the program and its inputs and warms
up, its passes are what the window runs, and its check gives the numbers
compared. The driver keeps what every loop shares. ``setup_s`` runs from
the process's start to the window's first tick.

The window runs the loop's passes in turn, in a closed loop of one caller:
a tick starts when the previous one returned. With ``commands_to_host``
``every_tick`` a tick ends when its commands are on the host and the window
ends with the tick that crosses ``seconds``; with ``every_pass`` the device
is synchronised at the end of each pass and the window ends with the round
of passes that crosses ``seconds``. Every tick keeps its solver statuses
and its record; the check runs once the window has closed and its peak
memory has been read, and the loop frees the program's state before its
reference runs. A lane-tick counts as failed where its status is neither
solved nor solved inaccurate, and so does each checked output that is not
finite.

``--trace 1`` runs ``trace_ticks`` ticks of each pass instead, under
``torch.profiler``, with the kernel wrappers' calls recorded, each
batch-wide decision in a span of its own and the program's counters read
before and after, and reports the per-layer metrics
(``mpcbench/core/readers.py`` lists what a reader is handed).
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from . import check, port, spec, trace, traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "ironcub_mpc_tpu")
# the port's solver statuses (ops/admm.py)
STATUS = {0: "unsolved", 1: "solved", 2: "solved_inaccurate",
          3: "primal_infeasible", 4: "dual_infeasible", 5: "max_iter"}


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _power_limit(index: int):
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
        return out.stdout.strip().splitlines()[index]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class _NoSpan:
    def __call__(self, name):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOSPAN = _NoSpan()


class Cell:
    """A cell after set-up: its entries of the spec read, and the loop its
    traffic mix names, set up (``loop``)."""

    def __init__(self, name, seed, device, overrides=None):
        self.name = name
        self.bench = spec.benchmark()
        wl = spec.workload(self.bench, name)
        self.config_path = spec.config_path(self.bench, wl["config"])
        self.config = spec.config(self.bench, wl["config"])
        self.traffic = traffic_mod.load(spec.traffic_path(wl["traffic"]))
        self.traffic.update(overrides or {})
        self.limits = spec.cell(name)["limits"]
        self.dev = torch.device(device)
        self.lanes = int(self.traffic["lanes"])
        self.per_tick = self.traffic["commands_to_host"] == "every_tick"
        self.loop = spec.loop(self.traffic["loop"]).Loop(self, seed)


def measure(cell: Cell, seconds: float):
    """The window: (seconds, latencies, records, statuses)."""
    loop = cell.loop
    records, statuses, lat = [], [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    running = True
    while running:
        for s in loop.passes:
            if not loop.run_pass(s, records, statuses, latencies=lat,
                                 deadline=deadline):
                running = False
                break
        if not cell.per_tick and time.perf_counter() >= deadline:
            running = False
    sync(cell.dev)
    return t0, time.perf_counter() - t0, lat, records, statuses


def traced(cell: Cell):
    """The traced window: (records, statuses, per-layer context)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cell.dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    records, statuses, calls = [], [], {}
    n = int(cell.traffic["trace_ticks"])
    before = port.counters()
    with port.instrument(calls) as spans:
        with profile(activities=activities) as prof:
            with record_function(trace.WINDOW_SPAN):
                for s in cell.loop.passes:
                    cell.loop.run_pass(s, records, statuses, n_ticks=n,
                                       span=record_function)
                sync(cell.dev)
    after = port.counters()
    counters = {k: v - before.get(k, 0) for k, v in after.items()}
    events = prof.events()
    cuda = cell.dev.type == "cuda"
    ctx = dict(ticks=len(records), lanes=cell.lanes, counters=counters,
               calls=calls, roofline=spec.roofline, peaks=spec.peaks(),
               events=events,
               trace=trace.read(events, spans) if cuda else None,
               memory_peak_bytes=(int(torch.cuda.max_memory_allocated(
                   cell.dev)) if cuda else None))
    return records, statuses, ctx


def _device(cell: Cell) -> dict:
    if cell.dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    index = cell.dev.index or 0
    return dict(platform="gpu", kind=torch.cuda.get_device_name(index),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    cell.dev)),
                power_limit=_power_limit(index))


def _check(cell: Cell, records, statuses, detail=None):
    """(attempted, failed, correct, table) of a window's records."""
    st = torch.stack(statuses).cpu().numpy()
    attempted = int(st.size)
    failed = int((~np.isin(st, (1, 2))).sum())
    numbers = cell.loop.check(records, statuses, detail)
    failed += numbers["nonfinite"]
    correct, table = check.judge(numbers, cell.limits)
    return attempted, failed, correct, table


def lead_in_statuses(cell: Cell) -> dict:
    """{pass: {solver status: lane-ticks}} of the ticks the loop's set-up
    ran from the controller's cold carry (``PERF.md`` §7): outside the
    window, ``attempted``, ``failed`` and the check, and shown beside
    them."""
    out = {}
    for s, sts in cell.loop.lead_in_status.items():
        st = torch.stack(sts).cpu().numpy()
        out[s] = {STATUS.get(int(v), str(int(v))): int((st == v).sum())
                  for v in np.unique(st)}
    return out


def run(name: str, seed: int, seconds: float, trace_on: bool,
        device="cuda", overrides=None, t_start=None, detail=None) -> dict:
    """One run of cell ``name``; the result line as a dict. ``detail``, a
    dict, receives every candidate number of the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, seed, device, overrides)
    metrics = {}
    if trace_on:
        records, statuses, ctx = traced(cell)
        for m in spec.per_layer(cell.bench, name):
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        dev = _device(cell)
        tr = ctx["trace"]
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = None if tr is None else dict(device_ops=tr.device_ops,
                                                 idle_gaps=tr.idle_gaps)
    else:
        t0, window_s, lat, records, statuses = measure(cell, seconds)
        n = len(records)
        have = dict(setup_s=t0 - t_start, tick_ms=1e3 * window_s / n,
                    lane_ticks_per_s=cell.lanes * n / window_s)
        if lat and cell.per_tick:
            have["tick_ms_p95"] = 1e3 * float(np.percentile(lat, 95))
        for m in spec.end_to_end(cell.bench, name):
            metrics[m["name"]] = dict(value=float(have[m["name"]]),
                                      unit=m["unit"])
        dev = _device(cell)
        breakdown = None
    attempted, failed, correct, table = _check(cell, records, statuses,
                                                detail)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["lead_in"] = lead_in_statuses(cell)
    out["check"] = table
    return out
