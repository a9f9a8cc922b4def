"""The Monte-Carlo sweep over the graphed closed loop (``parallel/
monte_carlo.py`` ``run_sweep`` over ``runtime/flight.py``'s loop: the
plant's substep and the snapshot replayed from CUDA graphs on the card,
batch-wide decisions, the recovery retry).

The card tests (marker ``gpu``) hold, at the sweep's 1024 lanes, each
lane under its own wind and thrust scale, a sweep whose every tick
replays the graphs to the same sweep with the eager substep and snapshot,
bit for bit: every carry, every telemetry and the result, over ticks that
include a forced retry (the retry replays both graphs from the tick's
first carry). And a sweep reads nothing back a tick beyond ``batch_any``'s
read-backs (the solver's gates, the retry's predicate): any other
synchronising call raises under the debug mode. The CPU tests: the
sweep's counters and spans, its callback, and the eager path.

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_graphed_sweep.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ironcub_mpc_tpu_torch.core.types import tree_map
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.parallel import monte_carlo
from ironcub_mpc_tpu_torch.parallel import (ScenarioConfig,
                                            make_batched_carry, run_sweep)
from ironcub_mpc_tpu_torch.qp import condensed
from ironcub_mpc_tpu_torch.runtime import checkpoint, flight
from ironcub_mpc_tpu_torch.runtime.loop import run_snapshot
from ironcub_mpc_tpu_torch.sim import plant as plant_mod

from test_torch_graphed_snapshot import bits, eager, same
from test_torch_sweep_oracle import forced_retry

SCEN = ScenarioConfig(wind_force_std=5.0, com_err_fail=1.0)
SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops on one thread: the test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def arrays(name, prefix) -> dict:
    from mpcbench.core import spec

    z = np.load(spec.stream_path(name))
    return {k: torch.as_tensor(z[k]) for k in z.files
            if k.startswith(prefix + ".")}


def sweep_setup(device, lanes):
    """(loop, problem, batched carry): the flight loop at the sweep's
    settings on ``device`` (batch-wide decisions; the kernels' plain path on
    the CPU), configured on the settled start, the airborne branch
    perturbed for ``lanes`` lanes."""
    loop, pos, alpha = flight.build_flight_loop(device=device)
    loop.settings = dataclasses.replace(
        loop.settings, batch_guard=True,
        kernel_mode="auto" if device == "cuda" else "off")
    settled = checkpoint.unflatten(
        arrays("flight_start", "plant"), "plant",
        flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg))
    problem, one = loop.configure(settled, *flight.mission_inputs(pos, alpha))
    carry = checkpoint.unflatten(arrays("flight_airborne", "carry"), "carry",
                                 one)
    return loop, problem, make_batched_carry(carry, lanes, SCEN, seed=SEED)


def counts():
    return (monte_carlo._sweep_tick.ticks, monte_carlo._sweep_tick.retries,
            monte_carlo.run_sweep.sweeps)


# ---------------------------------------------------------------------------
# CPU: counters, spans, the callback, the eager path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu():
    return sweep_setup("cpu", 2)


def test_counters_move_by_ticks_retries_and_sweeps(cpu, monkeypatch):
    """A sweep of 3 ticks with one forced retry moves ``_sweep_tick.ticks``
    by 3, ``.retries`` by 1 and ``run_sweep.sweeps`` by 1; on the CPU the
    loop runs eagerly (no graph replayed)."""
    loop, problem, batched = cpu
    forced_retry(loop, monkeypatch, at=1, lane=1)
    before = counts()
    graphed = (plant_mod.run_substeps.graphed_substeps,
               run_snapshot.graphed_snapshots)
    res = run_sweep(loop, problem, batched, 3, scen=SCEN, recover=True)
    assert counts() == (before[0] + 3, before[1] + 1, before[2] + 1)
    assert (int(res.n_ticks_retried), int(res.n_ticks_recovered)) == (1, 1)
    assert (plant_mod.run_substeps.graphed_substeps,
            run_snapshot.graphed_snapshots) == graphed
    # without the retry the predicate is read and nothing re-runs
    before = counts()
    monkeypatch.undo()
    run_sweep(loop, problem, batched, 2, scen=SCEN, recover=False)
    assert counts() == (before[0] + 2, before[1], before[2] + 1)


def test_spans_name_the_sweeps_own_work(cpu, monkeypatch):
    """Under the profiler each tick has one ``sweep.gate`` (holding the
    predicate's ``batch_any``) and one ``sweep.stats``; the retried tick a
    ``sweep.retry`` around its second ``loop.tick``; the sweep one
    ``sweep.reduce``."""
    loop, problem, batched = cpu
    forced_retry(loop, monkeypatch, at=0, lane=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_sweep(loop, problem, batched, 2, scen=SCEN, recover=True)
    events = prof.events()

    def named(name):
        return [e for e in events if e.name == name]

    assert [len(named(n)) for n in ("sweep.gate", "sweep.stats",
                                    "sweep.retry", "sweep.reduce",
                                    "loop.tick")] == [2, 2, 1, 1, 3]
    retry = named("sweep.retry")[0].time_range
    inside = [e for e in named("loop.tick")
              if retry.start <= e.time_range.start
              and e.time_range.end <= retry.end]
    assert len(inside) == 1


def test_callback_gets_the_carry_after_the_tick(cpu):
    """The callback gets each tick's telemetry and the carry after the
    tick: the plant state the next tick starts from."""
    loop, problem, batched = cpu
    ticks = []
    run_sweep(loop, problem, batched, 2, scen=SCEN,
              on_tick=lambda tel, carry: ticks.append((tel, carry)))
    assert len(ticks) == 2
    # a tick's telemetry measures the state it started from: the carry
    # the callback was handed after the tick before
    starts = [batched.plant, ticks[0][1].plant]
    for (tel, carry), s in zip(ticks, starts):
        assert type(tel).__name__ == "TickTelemetry"
        assert type(carry).__name__ == "LoopCarry"
        assert same(tel.base_position, s.base_p)
        assert same(tel.joints_pos_meas, s.q)
    assert not same(ticks[1][1].plant.base_p, batched.plant.base_p)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

LANES = 1024


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plant and the snapshot are "
                    "graphed only on the card")
    kernels.build()
    return sweep_setup("cuda", LANES)


def traced_sweep(setup, n, monkeypatch, graphed: bool):
    """(result, [(telemetry, carry)] a tick) of an ``n``-tick sweep with a
    forced retry at tick 2, the plant and the snapshot graphed or
    eager."""
    loop, problem, batched = setup
    forced_retry(loop, monkeypatch, at=2, lane=LANES // 3)
    if not graphed:
        monkeypatch.setattr(plant_mod, "_graphs_engage", lambda dev: False)
        monkeypatch.setattr(loop, "snapshot", lambda s: eager(loop, s))
    before = (plant_mod.run_substeps.graphed_substeps,
              run_snapshot.graphed_snapshots)
    ticks = []
    res = run_sweep(loop, problem, tree_map(torch.clone, batched), n,
                    scen=SCEN, recover=True,
                    on_tick=lambda tel, carry: ticks.append((tel, carry)))
    moved = (plant_mod.run_substeps.graphed_substeps - before[0],
             run_snapshot.graphed_snapshots - before[1])
    # n ticks and the retry: n + 1 closed-loop ticks, five substeps each
    assert moved == (((n + 1) * 5, n + 1) if graphed else (0, 0))
    monkeypatch.undo()
    return res, ticks


@pytest.mark.gpu
def test_graphed_sweep_equals_the_eager_sweep(card, monkeypatch):
    """Six ticks of 1024 perturbed lanes with a forced retry at tick 2,
    the plant and the snapshot replayed from their graphs, against the
    same six eager: every carry and telemetry and the result bit for
    bit."""
    loop = card[0]
    assert bool((card[2].plant.thrust_scale != 1.0).all())
    run_sweep(loop, card[1], card[2], 1, scen=SCEN)    # captures the graphs
    got = traced_sweep(card, 6, monkeypatch, graphed=True)
    want = traced_sweep(card, 6, monkeypatch, graphed=False)
    for t, (a, b) in enumerate(zip(got[1], want[1])):
        assert same(a, b), f"tick {t}"
    assert same(tuple(got[0]), tuple(want[0]))
    assert (int(got[0].n_ticks_retried), int(got[0].n_ticks_recovered)) \
        == (1, 1)
    assert int(got[0].status_counts[:5].sum()) == 6 * LANES


@pytest.mark.gpu
def test_sweep_reads_back_only_its_decisions(card, monkeypatch):
    """Ticks of the sweep under the sync debug mode ``error``: only
    ``batch_any`` (the solver's gates and the retry's predicate, counted)
    and the final reduction (``_reduce``, once a sweep) may read the device
    back; any other synchronising call raises."""
    loop, problem, batched = card
    run_sweep(loop, problem, batched, 1, scen=SCEN, recover=True)

    def allowed(f):
        def call(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return f(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    # batch_any counts on the name it is called under, the wrapper's
    gate = allowed(condensed.batch_any)
    gate.syncs = 0
    monkeypatch.setattr(condensed, "batch_any", gate)
    monkeypatch.setattr(monte_carlo, "_reduce",
                        allowed(monte_carlo._reduce))
    forced_retry(loop, monkeypatch, at=1, lane=5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = run_sweep(loop, problem, batched, 3, scen=SCEN, recover=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(res.n_ticks_retried) == 1
    # the gates of four solves (three ticks and the retry) and three
    # predicates: at least one read-back each
    assert gate.syncs >= 7
    assert bits(res.lane_max_err).shape == (LANES,)


def test_plant_solve_leaves_the_cpu_path_and_the_backend_alone():
    """The plant's solve (``sim/plant.py`` ``_solve``) is ``solve_ex`` on
    the CPU, bit for bit, and leaves PyTorch's preferred linear-algebra
    library as it found it."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn((6, 29, 29), generator=g)
    lhs = a @ a.mT + 29.0 * torch.eye(29)
    rhs = torch.randn((6, 29, 1), generator=g)
    before = torch.backends.cuda.preferred_linalg_library()
    assert same(plant_mod._solve(lhs, rhs), torch.linalg.solve_ex(lhs, rhs)[0])
    assert torch.backends.cuda.preferred_linalg_library() == before
