"""The flight cell (``mk3_flight.flight_b1``, ``mpcbench/loops/flight.py``)
on the CPU and, ``-m gpu``, on the card: a window of short passes through
the driver; the faults only a closed loop can have, each of which the
check must read (the replay's faults, which the flight's MPC step also
meets through ``core/port.py``, run for every cell in
``test_mpcbench_faults.py``); the closed loop's spans and the readers of
what was launched or waited for inside them (``core/launches.py``); and
the flight's float64 reference loading nothing of the program."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from mpcbench.core import driver, launches, spans, spec, trace, traffic

from test_mpcbench_cells import CELLS
from test_mpcbench_imports import BLOCK, FORBIDDEN, ROOT, imported_names, \
    python
from test_mpcbench_spans import LAUNCHES, ctx_of, event, launched_kernels



def mix(name) -> dict:
    """The cell's traffic mix as the driver reads it."""
    return traffic.load(spec.traffic_path(
        spec.workload(spec.benchmark(), name)["traffic"]))


FLIGHT = [c for c in CELLS if mix(c)["loop"] == "flight"]
STAGES = ("loop.snapshot", "mpc.tick", "loop.apply", "loop.plant")
SHORT = dict(ticks=3, warm_passes=0, trace_ticks=3)


@pytest.mark.parametrize("name", FLIGHT)
def test_short_passes_run_and_check(name):
    """Passes of 3 ticks in turn: every tick checked step by step, the
    first pass from each start chained."""
    d = {}
    res = driver.run(name, 2 ** 31 + 71, 1.0, False, device="cpu",
                     overrides=SHORT, detail=d)
    assert res["attempted"] >= 6 and res["failed"] == 0
    assert res["correct"], res["check"]
    assert d["cases"] == res["attempted"] and res["lead_in"] == {}
    assert d["chained"] == SHORT["ticks"] * len(mix(name)["starts"])


def held_lstm(monkeypatch):
    """Every plant substep's LSTM returns the thrust it was given."""
    from ironcub_mpc_tpu_torch.sim import jet_lstm

    real = jet_lstm.LSTMJetModel.step

    def step(self, thrust, throttle, dt):
        return thrust, real(self, thrust, throttle, dt)[1]
    monkeypatch.setattr(jet_lstm.LSTMJetModel, "step", step)


def stale_plant(monkeypatch):
    """Every closed-loop tick returns the plant state it was given."""
    from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop

    real = ClosedLoop.tick

    def tick(self, problem, carry, settings=None):
        new, tel = real(self, problem, carry, settings)
        return new._replace(plant=carry.plant), tel
    tick.ticks = real.ticks       # the tick counts through its class
    monkeypatch.setattr(ClosedLoop, "tick", tick)


FAULTS = {"held_lstm": held_lstm, "stale_plant": stale_plant}


@pytest.mark.parametrize("name", FLIGHT)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_plant_fault_reads_incorrect(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = driver.run(name, 2 ** 31 + 72, 0.5, False, device="cpu",
                     overrides=SHORT)
    assert not res["correct"]
    assert [k for k, v in res["check"].items() if v["value"] > v["limit"]], \
        res["check"]


def test_launch_readers_follow_correlation_ids():
    """Device time of the kernels launched inside a span and the waits
    inside it, on synthetic events: a launch inside ``loop.plant`` (id 3)
    counts its kernel, one outside (id 4) does not; inside ``loop.tick`` a
    synchronise and a copy to the host count, a copy to the device and a
    synchronise after the span do not."""
    def device(name, start, end, id, **extra):
        return event(name, start, end, device=DeviceType.CUDA, id=id,
                     **extra)

    events = [event(trace.WINDOW_SPAN, 0.0, 1000.0, id=0),
              event("loop.tick", 100.0, 900.0, id=1),
              event("loop.plant", 500.0, 800.0, id=2),
              event("cudaLaunchKernel", 510.0, 520.0, id=3),
              event("cudaLaunchKernel", 200.0, 210.0, id=4),
              event("cudaMemcpyAsync", 300.0, 310.0, id=5),
              event("cudaMemcpyAsync", 320.0, 330.0, id=6),
              event("cudaStreamSynchronize", 340.0, 350.0, id=7),
              event("cudaStreamSynchronize", 950.0, 960.0, id=8),
              device("void step(float*)", 530.0, 560.0, 3),
              device("void other(float*)", 220.0, 260.0, 4),
              device("Memcpy DtoH (Device -> Pageable)", 311.0, 312.0, 5),
              device("Memcpy HtoD (Pageable -> Device)", 331.0, 332.0, 6),
              device("loop.plant", 500.0, 800.0, 2, is_user_annotation=True)]
    ctx = ctx_of(events, 2)
    assert launches.launched_inside(ctx, "loop.plant") == \
        pytest.approx(30.0 * 1e-3 / 2)
    assert launches.readbacks_inside(ctx, "loop.tick") == 2 / 2
    assert launches.launched_inside(ctx, "loop.snapshot") is None
    assert launches.readbacks_inside(ctx_of(events, 2, traced=False),
                                     "loop.tick") is None


def profiled_ticks(name, device, n):
    """(events, the loop) of ``n`` bare closed-loop ticks of the cell's
    first pass under the profiler, after two ticks outside it."""
    loop = driver.Cell(name, 2 ** 31 + 73, device,
                       overrides=dict(warm_passes=0)).loop
    loop.run_pass(loop.passes[0], [], [], n_ticks=2)
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        torch.cuda.synchronize()
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW_SPAN):
            loop.run_pass(loop.passes[0], [], [], n_ticks=n,
                          span=record_function)
            driver.sync(torch.device(device))
    return prof.events(), loop


def stage_shares(ctx):
    tick = spans.host_ms_per_tick(ctx, "loop.tick")
    stages = [spans.host_ms_per_tick(ctx, s) for s in STAGES]
    return tick, stages


@pytest.mark.parametrize("name", FLIGHT)
def test_closed_loop_stages_sum_to_the_tick(name):
    """The closed loop's stage spans on a CPU profile of three ticks: each
    reads, and together they hold at least 95 % of the ``loop.tick``
    spans' time; the plant's ``plant.jets`` lie inside ``loop.plant``."""
    events, _ = profiled_ticks(name, "cpu", 3)
    ctx = ctx_of(events, 3)
    tick, stages = stage_shares(ctx)
    assert all(v > 0 for v in stages)
    assert 0.95 * tick <= sum(stages) <= tick
    jets = spans.host_ms_per_tick(ctx, "plant.jets")
    assert 0 < jets < spans.host_ms_per_tick(ctx, "loop.plant")


@pytest.mark.gpu
@pytest.mark.parametrize("name", FLIGHT)
def test_loop_spans_hold_every_kernel_launch_of_the_window(name,
                                                           cuda_device):
    """Closed-loop ticks of a pass on the card: every kernel of the device
    timeline was launched inside a ``loop.tick`` span (a graph launch's
    kernels by its correlation id) or, the rows the harness copies to the
    host, inside its ``commands`` span; the loop's stages hold at least
    95 % of its host time, and the plant's readers read."""
    events, _ = profiled_ticks(name, cuda_device, 5)
    tr = trace.read(events)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    window = next(e for e in cpu if e.name == trace.WINDOW_SPAN)
    by_launch = launched_kernels(events, window)

    def launched_in(span):
        spans_ = [e for e in cpu if e.name == span]
        return spans_, sum(by_launch[e.id] for e in cpu
                           if e.name.startswith(LAUNCHES) and any(
                               t.time_range.start <= e.time_range.start
                               and e.time_range.end <= t.time_range.end
                               for t in spans_))

    ticks, in_ticks = launched_in("loop.tick")
    _, in_commands = launched_in("commands")
    assert len(ticks) == 5
    assert in_ticks + in_commands == len(tr.kernels)
    assert in_commands <= 5 * 4
    ctx = dict(events=events, ticks=5, trace=tr)
    tick, stages = stage_shares(ctx)
    assert 0.95 * tick <= sum(stages) <= tick
    assert launches.launched_inside(ctx, "loop.plant") > 0
    assert launches.readbacks_inside(ctx, "loop.tick") is not None


FLIGHT_REF = """
from mpcbench.reference import flight
import numpy as np
out = flight.chain_pass({config!r}, {start!r}, {carry!r}, np.zeros(3), 1)
assert out[0]["commands"]["throttle"].shape == (4,)
print(sorted({{m.split(".")[0] for m in sys.modules}} & BLOCKED))
"""


def test_flight_reference_loads_nothing_of_the_program():
    """The flight's float64 reference flies a tick with the program and
    JAX refused at import; its original in ``tests/`` names neither."""
    blocked = sorted(FORBIDDEN | {"ironcub_mpc_tpu_torch"})
    code = (BLOCK.format(root=str(ROOT), blocked=blocked)
            + FLIGHT_REF.format(
                config=str(ROOT / "mpcbench" / "configs" / "mk3_flight.json"),
                start=str(spec.stream_path("flight_start")),
                carry=str(spec.stream_path("flight_takeoff"))))
    assert python(code) == "[]"
    names = imported_names(ROOT / "tests" / "flight_oracle.py")
    assert not names & (FORBIDDEN | {"ironcub_mpc_tpu_torch", "mpcbench"})


def test_no_spans_read_none():
    """A program without the closed loop's spans (the parent's) reads
    None from the flight's span readers, and raises nothing."""
    events = [event(trace.WINDOW_SPAN, 0.0, 10.0), event("mpc.tick", 1, 2)]
    ctx = dict(events=events, ticks=1, trace=SimpleNamespace())
    for name in ("snapshot_host_ms.flight", "plant_host_ms.flight",
                 "jets_host_ms.flight", "plant_device_ms.flight",
                 "host_readbacks_per_tick.flight"):
        assert spec.metric_reader(name)(ctx) is None, name
