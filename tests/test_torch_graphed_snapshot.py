"""The closed loop's snapshot as a CUDA graph (``runtime/loop.py``
``run_snapshot``, ``_SnapshotGraph``).

On the card ``ClosedLoop.snapshot`` measures the base velocity eagerly,
copies the fields of the plant state the snapshot reads into the buffers of
one captured snapshot, replays it once and hands out a clone. The card
tests (marker ``gpu``) hold it, from the flight cell's recorded mid-mission
states (``mpcbench/streams/flight_*.npz``), to the eager snapshot bit for
bit, with the LSTM jets on and off and with sensor noise on, and a 20-tick
chain of ``ClosedLoop.tick`` to the same chain with the eager snapshot; and
check what a caller may rely on: the result outlives the next call, a new
layout captures once, the counters move by one, nothing waits. The CPU
tests: the eager path, the counters and the benchmark's reader.

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_graphed_snapshot.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.types import tree_map
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.runtime import checkpoint, flight
from ironcub_mpc_tpu_torch.runtime import loop as loop_mod
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop, run_snapshot
from ironcub_mpc_tpu_torch.sim.plant import Plant
from ironcub_mpc_tpu_torch.utils import graphs
from mpcbench.core import spec

STARTS = ("flight_takeoff", "flight_airborne")
VARIANTS = ("nn", "direct", "nn_noise")
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops on one thread: the test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def loops(device):
    """({variant: a closed loop on ``device``}, the flight's mission
    inputs): ``nn`` the flight's own loop (LSTM jets, no sensor noise),
    ``direct`` without the jets' model, ``nn_noise`` with sensor noise on
    the base velocity."""
    base, pos, alpha = flight.build_flight_loop(device=device)
    out = {"nn": base}
    for name, change in (("direct", dict(use_nn_jet_dynamics=False)),
                         ("nn_noise", dict(simulate_noise=True))):
        p = base.plant
        plant = Plant(p.kd, p.robot_cfg,
                      dataclasses.replace(p.sim_cfg, **change),
                      params=p.params, lstm=p.lstm)
        out[name] = ClosedLoop(plant, base.cfg, base.settings)
    return out, flight.mission_inputs(pos, alpha)


def arrays(name, prefix) -> dict:
    z = np.load(spec.stream_path(name))
    return {k: torch.as_tensor(z[k]) for k in z.files
            if k.startswith(prefix + ".")}


def start(loop, name, batch):
    """The recorded plant state of start ``name`` on ``batch`` lanes, each
    lane past the first under a wind and a joint velocity of its own."""
    plant = loop.plant
    like = flight.standing_state(plant, plant.sim_cfg.initial_position_deg)
    s = checkpoint.unflatten(arrays(name, "carry.plant"), "carry.plant",
                             like)
    s = tree_map(lambda t: t.expand(batch, *t.shape[1:]).contiguous(), s)
    g = np.random.default_rng(batch)
    dev, dt = s.base_p.device, s.base_p.dtype
    wind = torch.as_tensor(2.0 * g.standard_normal((batch, 3)), dtype=dt,
                           device=dev)
    nudge = torch.as_tensor(0.05 * g.standard_normal(s.qd.shape), dtype=dt,
                            device=dev)
    wind[0], nudge[0] = 0.0, 0.0
    return s._replace(wind_force=s.wind_force + wind, qd=s.qd + nudge)


def eager(loop, s):
    """The snapshot as ``ClosedLoop.snapshot`` computed it before it was
    graphed: the measured velocity, then ``compute_snapshot`` op by op."""
    lin, ang, s = loop.plant.measured_base_velocity(s)
    return loop_mod._snapshot(loop, s, torch.cat([lin, ang], dim=-1)), s


def bits(t):
    """``t`` with its floats read as integers of their width, so that equal
    means the same bits (a NaN equals itself, -0.0 differs from 0.0)."""
    t = t.contiguous()
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def same(a, b) -> bool:
    """Trees of tensors with the same dtypes, shapes and bits (None where
    None)."""
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def nones(tree) -> list:
    return [t is None for t in tree]


def counts():
    return (run_snapshot.snapshots, run_snapshot.graphed_snapshots,
            run_snapshot.graph_captures)


def moved(before, n, graphed, captures=0):
    return counts() == (before[0] + n, before[1] + (n if graphed else 0),
                        before[2] + captures)


# ---------------------------------------------------------------------------
# CPU: the eager path, the counters, the reader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_loops():
    return loops("cpu")[0]


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_snapshot_runs_eagerly(cpu_loops, variant):
    """On the CPU ``ClosedLoop.snapshot`` is the eager snapshot: the same
    bits (the same noise draws from the same seed), the caller's state
    back, no graph captured or replayed, the counters by one a call."""
    loop = cpu_loops[variant]
    s = start(loop, STARTS[1], 2)
    loop.plant.seed_noise(SEED)
    before = counts()
    snap, back = loop.snapshot(s)
    assert moved(before, 1, graphed=False)
    assert back is s
    loop.plant.seed_noise(SEED)
    want, _ = eager(loop, s)
    assert same(snap, want) and nones(snap) == nones(want)
    assert loop._snapshot_graphs == {}


def test_cpu_noise_moves_the_velocity_alone(cpu_loops):
    """Sensor noise reaches the snapshot only through the measured base
    velocity: another seed moves it and leaves the CoM as it was."""
    loop = cpu_loops["nn_noise"]
    s = start(loop, STARTS[0], 1)
    loop.plant.seed_noise(SEED)
    a, _ = loop.snapshot(s)
    loop.plant.seed_noise(SEED + 1)
    b, _ = loop.snapshot(s)
    assert not torch.equal(a.base_ang_vel_world, b.base_ang_vel_world)
    assert same(a.com_pos, b.com_pos)


def test_snapshot_fields_keep_what_the_snapshot_reads(cpu_loops):
    """The eager snapshot of the fields alone equals that of the whole
    state: nothing it reads is left out of the graph's inputs."""
    loop = cpu_loops["nn"]
    s = start(loop, STARTS[0], 2)
    fields = loop_mod._snapshot_fields(s)
    assert fields.ekf.P is None and fields.throttle is None
    base_vel = s.base_v.clone()
    assert same(loop_mod._snapshot(loop, fields, base_vel),
                loop_mod._snapshot(loop, s, base_vel))
    direct = cpu_loops["direct"]
    assert same(loop_mod._snapshot(direct, fields, base_vel),
                loop_mod._snapshot(direct, s, base_vel))


def test_snapshot_graphed_share_reader():
    """100 × graphed snapshots ÷ snapshots of the window; None where the
    program keeps no such counter or took no snapshot."""
    read = spec.metric_reader("snapshot_graphed_share.flight")
    c = "runtime.loop.run_snapshot."
    assert read(dict(ticks=80, counters={
        c + "snapshots": 80, c + "graphed_snapshots": 80})) == 100.0
    assert read(dict(ticks=80, counters={
        c + "snapshots": 80, c + "graphed_snapshots": 20})) == 25.0
    assert read(dict(ticks=80, counters={
        c + "snapshots": 0, c + "graphed_snapshots": 0})) is None
    assert read(dict(ticks=80, counters={
        "sim.plant.run_substeps.substeps": 400})) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the snapshot is graphed only on "
                    "the card")
    return loops("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", STARTS)
def test_graphed_snapshot_equals_the_eager_one(card, name, batch, variant):
    """The snapshots of four states five substeps apart, graphed and eager
    from the same noise seed: the same bits, the caller's state back."""
    loop = card[0][variant]
    s = start(loop, name, batch)
    for k in range(4):
        loop.plant.seed_noise(SEED + k)
        got, back = loop.snapshot(s)
        loop.plant.seed_noise(SEED + k)
        want, _ = eager(loop, s)
        assert back is s
        assert same(got, want) and nones(got) == nones(want), f"state {k}"
        s = loop.plant.step(s, 5)
    assert bool(torch.isfinite(got.momentum_body).all())


def configured(loop, inputs, name):
    """(problem, carry) of the flight's controller configured on its
    settled start and restored to the recorded start ``name``."""
    plant = loop.plant
    settled = checkpoint.unflatten(
        arrays("flight_start", "plant"), "plant",
        flight.standing_state(plant, plant.sim_cfg.initial_position_deg))
    problem, carry0 = loop.configure(settled, *inputs)
    one = tree_map(lambda t: t[:1], carry0)
    return problem, checkpoint.unflatten(arrays(name, "carry"), "carry",
                                         one)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["nn", "nn_noise"])
def test_graphed_tick_chain_equals_the_eager_chain(card, variant):
    """20 ticks of ``ClosedLoop.tick`` from a recorded start, the snapshot
    graphed, against the same 20 with the eager snapshot: every carry and
    telemetry bit for bit."""
    kernels.build()
    loops_, inputs = card
    loop = loops_[variant]
    problem, carry0 = configured(loop, inputs, STARTS[0])
    chains = []
    for graphed in (True, False):
        loop.plant.seed_noise(SEED)
        if not graphed:
            loop.snapshot = lambda s: eager(loop, s)
        try:
            before = run_snapshot.graphed_snapshots
            carry, out = tree_map(torch.clone, carry0), []
            for _ in range(20):
                carry, tel = loop.tick(problem, carry)
                out.append((carry, tel))
            assert run_snapshot.graphed_snapshots == before + (
                20 if graphed else 0)
        finally:
            loop.__dict__.pop("snapshot", None)
        chains.append(out)
    for t, (got, want) in enumerate(zip(*chains)):
        assert same(got, want), f"tick {t + 1}"
    assert int(chains[0][-1][1].solver_status[0]) in (1, 2)


@pytest.mark.gpu
def test_snapshot_outlives_the_next_call(card):
    """What a snapshot returned belongs to its caller: the next replays,
    of another state, leave it as it was."""
    loop = card[0]["nn"]
    s = start(loop, STARTS[1], 1)
    a, _ = loop.snapshot(s)
    kept = tree_map(torch.clone, a)
    s = loop.plant.step(s, 5)
    loop.snapshot(loop.plant.step(s, 5))
    loop.snapshot(s)
    assert same(a, kept)


@pytest.mark.gpu
def test_a_new_layout_captures_once(card):
    """A lane count the loop has not measured yet captures at its first
    call and replays after; each call moves the counters by one."""
    loop = card[0]["direct"]
    s = start(loop, STARTS[0], 3)
    before = counts()
    loop.snapshot(s)
    assert moved(before, 1, graphed=True, captures=1)
    before = counts()
    loop.snapshot(s)
    assert moved(before, 1, graphed=True)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_snapshot_never_waits_for_the_device(card, variant):
    """A replay reads nothing back and copies nothing from the host (any
    synchronising call raises under the debug mode), noise draws
    included."""
    loop = card[0][variant]
    s = start(loop, STARTS[1], 1)
    loop.snapshot(s)
    torch.cuda.synchronize()
    before = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop.snapshot(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert moved(before, 1, graphed=True)
