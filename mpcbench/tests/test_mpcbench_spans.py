"""The readers of the program's own spans (``mpcbench/core/spans.py``): on
synthetic events (clipped to the window, over its ticks, None without a
trace or a span), on a real CPU profile of the port's ticks, and, ``-m gpu``,
the ``mpc.tick`` spans on the card: the kernels launched inside them, a
graph launch's by the profiler's correlation ids, are every kernel the
window's device timeline holds."""

from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from mpcbench.core import driver, port, spans, spec, trace

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
STAGES = ("mpc.prep", "mpc.condense", "mpc.solve", "mpc.finish")
LAUNCHES = ("cudaLaunchKernel", "cuLaunch", "cudaGraphLaunch")


def event(name, start, end, thread=1, device=DeviceType.CPU, **extra):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           **extra)


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
    replay = driver.Cell("mk3_paper.lanes_b1024", 2 ** 31 + 61, "cpu",
                         overrides=dict(lanes=2, check_lanes=1,
                                        warm_passes=0)).loop
    problem, carry, _, inputs = next(iter(replay.streams.values()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for snap, est in inputs[:3]:
                carry, _ = port.tick(replay.ctl, problem, carry, snap, est)
    ctx = ctx_of(prof.events(), 3)
    tick = spans.host_ms_per_tick(ctx, "mpc.tick")
    stages = [spans.host_ms_per_tick(ctx, s) for s in STAGES]
    assert all(v > 0 for v in stages)
    assert 0.9 * tick <= sum(stages) <= tick


def launched_kernels(events, window) -> Counter:
    """{correlation id: kernels} of the device timeline in ``window``,
    counted as ``trace.read`` counts them. The profiler gives a kernel the
    correlation id of the host call that launched it, and each kernel of a
    graph the id of its ``cudaGraphLaunch``."""
    w0, w1 = window.time_range.start, window.time_range.end
    return Counter(
        e.id for e in events
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name not in trace.SPANS
        and not e.name.startswith(trace.NOT_KERNELS)
        and e.time_range.end > w0 and e.time_range.start < w1)


def test_a_launch_counts_the_kernels_it_started():
    """A graph launch (id 7) counts its graph's kernels, copies and the
    spans' device copies left out; a kernel's launch (id 8) its kernel inside
    the window."""
    window = event(trace.WINDOW_SPAN, 0.0, 100.0)

    def device(name, start, id, **extra):
        return event(name, start, start + 1.0, device=DeviceType.CUDA, id=id,
                     **extra)

    events = [window, device("void gemv<4>(float*)", 10.0, 7),
              device("memcpy32_post", 11.0, 7),
              device("Memcpy DtoD (Device -> Device)", 12.0, 7),
              device("mpc.prep", 10.0, 7, is_user_annotation=True),
              device("void fill(float*)", 20.0, 8),
              device("void late(float*)", 120.0, 8)]
    count = launched_kernels(events, window)
    assert (count[7], count[8]) == (2, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_tick_spans_hold_every_kernel_launch_of_the_window(name,
                                                           cuda_device):
    """A window of bare ticks on the card: every kernel of the device
    timeline (``trace.read``, which leaves the spans' device copies out) was
    launched inside an ``mpc.tick`` span on the host, on the profiler's one
    clock. A launch counts the kernels that carry its correlation id: one for
    a kernel's launch, each kernel of its graph for a graph launch."""
    replay = driver.Cell(name, 2 ** 31 + 62, cuda_device,
                         overrides=dict(warm_passes=0)).loop
    problem, carry, _, inputs = next(iter(replay.streams.values()))
    for snap, est in inputs[:2]:
        carry, _ = port.tick(replay.ctl, problem, carry, snap, est)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for snap, est in inputs[2:7]:
                carry, _ = port.tick(replay.ctl, problem, carry, snap, est)
            torch.cuda.synchronize()
    events = prof.events()
    tr = trace.read(events)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ticks = [e for e in cpu if e.name == "mpc.tick"]
    launches = [e for e in cpu if e.name.startswith(LAUNCHES)]
    inside = [e for e in launches if any(
        t.time_range.start <= e.time_range.start
        and e.time_range.end <= t.time_range.end for t in ticks)]
    window = next(e for e in cpu if e.name == trace.WINDOW_SPAN)
    by_launch = launched_kernels(events, window)
    orphans = sum(by_launch.values()) - sum(by_launch[e.id] for e in launches)
    assert len(ticks) == 5
    assert (sum(by_launch[e.id] for e in inside)
            == sum(by_launch[e.id] for e in launches) == len(tr.kernels)), (
        sum(by_launch[e.id] for e in inside),
        sum(by_launch[e.id] for e in launches), len(tr.kernels), orphans,
        sorted({e.name for e in launches}))
