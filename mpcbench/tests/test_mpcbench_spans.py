"""The readers of the program's own spans (``mpcbench/core/spans.py``): on
synthetic events (clipped to the window, over its ticks, None without a
trace or a span), on a real CPU profile of the port's ticks, and, ``-m gpu``,
the ``mpc.tick`` spans on the card: the kernel launches inside them are
every kernel the window's device timeline holds."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from mpcbench.core import driver, port, spans, spec, trace

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
STAGES = ("mpc.prep", "mpc.condense", "mpc.solve", "mpc.finish")
LAUNCHES = ("cudaLaunchKernel", "cuLaunch")


def event(name, start, end, thread=1, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


def ctx_of(events, ticks, traced=True):
    return dict(events=events, ticks=ticks,
                trace=object() if traced else None)


def test_host_ms_clips_to_the_window_and_divides_by_ticks():
    events = [event(trace.WINDOW_SPAN, 1000.0, 9000.0),
              event("mpc.prep", 500.0, 1500.0),        # 500 us inside
              event("mpc.prep", 2000.0, 4000.0),       # 2000
              event("mpc.prep", 8500.0, 9500.0),       # 500
              event("mpc.prep", 9500.0, 9900.0),       # after the window
              event("mpc.prep", 3000.0, 5000.0, thread=2),
              event("mpc.prep", 3000.0, 5000.0, device=DeviceType.CUDA)]
    assert spans.host_ms_per_tick(ctx_of(events, 2), "mpc.prep") == \
        pytest.approx(3.0 / 2)


def test_host_ms_is_none_without_a_trace_or_a_span():
    events = [event(trace.WINDOW_SPAN, 0.0, 10.0),
              event("mpc.prep", 1.0, 2.0)]
    assert spans.host_ms_per_tick(ctx_of(events, 1, traced=False),
                                  "mpc.prep") is None
    assert spans.host_ms_per_tick(ctx_of(events, 1), "mpc.solve") is None
    assert spans.host_ms_per_tick(ctx_of(events[1:], 1), "mpc.prep") is None


def test_stage_spans_of_a_cpu_profile_sum_to_the_tick():
    """The port's stage spans on a CPU profile of three ticks: each reads,
    and together they hold nearly all of the ``mpc.tick`` spans' time."""
    cell = driver.Cell("mk3_paper.lanes_b1024", 2 ** 31 + 61, "cpu",
                       overrides=dict(lanes=2, check_lanes=1, warm_passes=0))
    problem, carry, _, inputs = next(iter(cell.streams.values()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for snap, est in inputs[:3]:
                carry, _ = port.tick(cell.ctl, problem, carry, snap, est)
    ctx = ctx_of(prof.events(), 3)
    tick = spans.host_ms_per_tick(ctx, "mpc.tick")
    stages = [spans.host_ms_per_tick(ctx, s) for s in STAGES]
    assert all(v > 0 for v in stages)
    assert 0.9 * tick <= sum(stages) <= tick


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_tick_spans_hold_every_kernel_launch_of_the_window(name,
                                                           cuda_device):
    """A window of bare ticks on the card: every kernel of the device
    timeline (``trace.read``, which leaves the spans' device copies out) was
    launched inside an ``mpc.tick`` span on the host, on the profiler's one
    clock."""
    cell = driver.Cell(name, 2 ** 31 + 62, cuda_device,
                       overrides=dict(warm_passes=0))
    problem, carry, _, inputs = next(iter(cell.streams.values()))
    for snap, est in inputs[:2]:
        carry, _ = port.tick(cell.ctl, problem, carry, snap, est)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for snap, est in inputs[2:7]:
                carry, _ = port.tick(cell.ctl, problem, carry, snap, est)
            torch.cuda.synchronize()
    events = prof.events()
    tr = trace.read(events)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ticks = [e for e in cpu if e.name == "mpc.tick"]
    launches = [e for e in cpu if e.name.startswith(LAUNCHES)]
    inside = [e for e in launches if any(
        t.time_range.start <= e.time_range.start
        and e.time_range.end <= t.time_range.end for t in ticks)]
    assert len(ticks) == 5
    assert len(inside) == len(launches) == len(tr.kernels), (
        len(inside), len(launches), len(tr.kernels),
        sorted({e.name for e in launches}))
