"""The plant's substep as a CUDA graph (``sim/plant.py`` ``run_substeps``,
``_SubstepGraph``).

On the card ``Plant.step(s, n)`` copies the state into the buffers of one
captured substep, replays it ``n`` times in place and hands out a clone. The
card tests (marker ``gpu``) hold it, from the flight cell's recorded
mid-mission states (``mpcbench/streams/flight_*.npz``), to the eager loop of
``Plant.substep`` bit for bit, with the LSTM jets on and off, and check what
a caller may rely on: the result outlives the next step, a restored state
repeats, a new layout captures once, the counters move by ``n``. The CPU
tests: the eager path, the rule that picks the path, the layout key, the
static buffers' copy and the benchmark's reader of the counters.

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_graphed_plant.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.types import tree_map
from ironcub_mpc_tpu_torch.runtime import checkpoint, flight
from ironcub_mpc_tpu_torch.sim import plant as plant_mod
from ironcub_mpc_tpu_torch.sim.plant import Plant, run_substeps
from ironcub_mpc_tpu_torch.utils import graphs
from mpcbench.core import spec

STARTS = ("flight_takeoff", "flight_airborne")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops on one thread: the test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def plants(device) -> dict:
    """{LSTM jets on: the flight's plant, off: the same plant without
    them}, on ``device``."""
    nn = flight.build_flight_loop(device=device)[0].plant
    off = Plant(nn.kd, nn.robot_cfg,
                dataclasses.replace(nn.sim_cfg, use_nn_jet_dynamics=False),
                params=nn.params)
    return {True: nn, False: off}


def start(plant, name, batch):
    """The recorded plant state of start ``name`` on ``batch`` lanes, each
    lane past the first under a wind and a throttle of its own."""
    z = np.load(spec.stream_path(name))
    flat = {k: torch.as_tensor(z[k]) for k in z.files
            if k.startswith("carry.plant.")}
    like = flight.standing_state(plant, plant.sim_cfg.initial_position_deg)
    s = checkpoint.unflatten(flat, "carry.plant", like)
    s = tree_map(lambda t: t.expand(batch, *t.shape[1:]).contiguous(), s)
    g = np.random.default_rng(batch)
    dev, dt = s.base_p.device, s.base_p.dtype
    wind = torch.as_tensor(2.0 * g.standard_normal((batch, 3)), dtype=dt,
                           device=dev)
    nudge = torch.as_tensor(g.uniform(-2.0, 2.0, (batch, 4)), dtype=dt,
                            device=dev)
    wind[0], nudge[0] = 0.0, 0.0
    return s._replace(wind_force=s.wind_force + wind,
                      throttle=s.throttle + nudge)


def eager(plant, s, n):
    for _ in range(n):
        s = plant.substep(s)
    return s


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


def counts():
    return (run_substeps.substeps, run_substeps.graphed_substeps,
            run_substeps.graph_captures, Plant.substep.substeps)


def moved(before, n, graphed, captures=0):
    return counts() == (before[0] + n, before[1] + (n if graphed else 0),
                        before[2] + captures, before[3] + n)


# ---------------------------------------------------------------------------
# CPU: the eager path, the rule, the layout, the buffers, the reader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_plants():
    return plants("cpu")


@pytest.mark.parametrize("nn", [True, False])
def test_cpu_step_runs_eagerly(cpu_plants, nn):
    """On the CPU ``Plant.step`` is the loop of ``substep``: the same bits,
    no graph captured or replayed, every counter of the substeps by n."""
    plant = cpu_plants[nn]
    s = start(plant, STARTS[1], 2)
    before = counts()
    got = plant.step(s, 3)
    assert moved(before, 3, graphed=False)
    assert same(got, eager(plant, s, 3))
    assert plant._graphs == {}


@pytest.mark.parametrize("device, engages", [
    ("cuda", True), ("cuda:1", True), ("cpu", False), ("meta", False)])
def test_graphs_engage_on_cuda_alone(device, engages):
    """The path is the device's alone: no setting, batch or jet model."""
    assert plant_mod._graphs_engage(torch.device(device)) is engages


def test_layout_keys_shape_dtype_none_and_device(cpu_plants):
    """A clone or a new wind has the captured layout; another batch, dtype
    or None field does not."""
    s = start(cpu_plants[True], STARTS[0], 2)
    key = plant_mod._layout(s)
    assert plant_mod._layout(tree_map(torch.clone, s)) == key
    assert plant_mod._layout(
        s._replace(wind_force=s.wind_force + 1.0)) == key
    others = [start(cpu_plants[True], STARTS[0], 3),
              tree_map(lambda t: t.double(), s),
              s._replace(jet_pos_offset=None)]
    assert len({key, *map(plant_mod._layout, others)}) == 4


def test_static_inputs_keep_a_position_that_holds_its_buffer():
    """A tree written back over the buffers it was computed from: the
    positions that hold their own buffer are left alone, the rest copied."""
    static = graphs.StaticInputs((torch.zeros(3), torch.zeros(2), None))
    static.copy_from((torch.full((3,), 4.0), torch.full((2,), 5.0), None))
    buf = static.tree
    static.copy_from((buf[0], torch.arange(6.0).reshape(2, 3)[:, 1], None))
    assert same(static.tree, (torch.full((3,), 4.0),
                              torch.tensor([1.0, 4.0]), None))
    assert static.tree[0] is buf[0]


def test_plant_graphed_share_reader():
    """100 × graphed substeps ÷ substeps of the window; None where the
    program keeps no such counter or ran no substep."""
    read = spec.metric_reader("plant_graphed_share.flight")
    c = "sim.plant.run_substeps."
    assert read(dict(ticks=80, counters={
        c + "substeps": 400, c + "graphed_substeps": 400})) == 100.0
    assert read(dict(ticks=80, counters={
        c + "substeps": 400, c + "graphed_substeps": 100})) == 25.0
    assert read(dict(ticks=80, counters={
        c + "substeps": 0, c + "graphed_substeps": 0})) is None
    assert read(dict(ticks=80, counters={
        "sim.plant.Plant.substep.substeps": 400})) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the substep is graphed only on "
                    "the card")
    return plants("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nn", [True, False])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", STARTS)
def test_graphed_step_equals_the_eager_substeps(card, name, batch, nn):
    """50 substeps as ten chained steps of 5: after each, the whole state
    bit for bit as the eager loop's."""
    plant = card[nn]
    s = start(plant, name, batch)
    got, want = s, s
    for k in range(10):
        got = plant.step(got, 5)
        want = eager(plant, want, 5)
        assert same(got, want), f"after {5 * (k + 1)} substeps"
    assert bool(torch.isfinite(got.base_v).all())


@pytest.mark.gpu
def test_returned_state_outlives_the_next_step(card):
    """What a step returned belongs to its caller: the next replays leave
    it as it was."""
    plant = card[True]
    a = plant.step(start(plant, STARTS[0], 1), 5)
    kept = tree_map(torch.clone, a)
    plant.step(plant.step(a, 5), 5)
    assert same(a, kept)


@pytest.mark.gpu
def test_a_restored_state_repeats(card, tmp_path):
    """A state saved through ``runtime/checkpoint.py`` and restored (new
    addresses) repeats the same substeps from the graph captured once."""
    plant = card[True]
    s = plant.step(start(plant, STARTS[1], 1), 5)
    path = checkpoint.write(tmp_path / "plant.pt", checkpoint.flatten(
        "plant", s))
    restored = checkpoint.unflatten(checkpoint.read(path), "plant", s)
    captures = run_substeps.graph_captures
    assert same(plant.step(restored, 20), plant.step(s, 20))
    assert run_substeps.graph_captures == captures


@pytest.mark.gpu
def test_a_new_batch_captures_once(card):
    """A lane count the plant has not stepped yet captures at its first
    call and replays after."""
    plant = card[True]
    s = start(plant, STARTS[0], 3)
    before = counts()
    plant.step(s, 5)
    assert moved(before, 5, graphed=True, captures=1)
    before = counts()
    plant.step(s, 5)
    assert moved(before, 5, graphed=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 7])
def test_counters_move_by_n_and_nothing_waits(card, n):
    """Every call moves ``substeps``, ``graphed_substeps`` and
    ``Plant.substep.substeps`` by n; a replay reads nothing back (any
    synchronising call raises under the debug mode)."""
    plant = card[False]
    s = start(plant, STARTS[1], 1)
    plant.step(s, 1)
    torch.cuda.synchronize()
    before = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plant.step(s, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert moved(before, n, graphed=True)
