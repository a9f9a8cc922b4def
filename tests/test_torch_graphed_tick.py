"""The condensed tick as CUDA graphs (``qp/mpc.py`` ``_TickGraphs``,
``utils/graphs.py``).

On the card, with per-lane decisions, ``mpc_tick`` replays each stage's
PyTorch work as graphs between the hand-written kernels' eager calls. The
card tests (marker ``gpu``) hold it on the recorded stream
(``tests/golden/flight_snapshots.npz``) to the eager tick bit for bit, the
kernels called through their module on every replay and the counters
moving as eagerly. The CPU tests: the eager path where no graph may run,
the rule that picks the path, the flat buffers and the benchmark's two
readers of ``mpc_tick.graphed_ticks``.

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_graphed_tick.py``.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.config import MPCConfig
from ironcub_mpc_tpu_torch.core.types import expand_lanes, tree_map
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
from ironcub_mpc_tpu_torch.ops import admm, kernels
from ironcub_mpc_tpu_torch.qp import condensed, mpc
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay
from ironcub_mpc_tpu_torch.utils import graphs
from mpcbench.core import spec

# the benchmark's solver (mpcbench/configs/mk3_paper.json): 40 iterations, a
# ρ update at 15, polish, so 8 segment and 3 refresh calls a tick
SETTINGS = admm.ADMMSettings(max_iter=40, polish=True, rho_update_iters=(15,),
                             kinv_guard=True, ns_skip_tol=0.02,
                             term_check_every=5, kernel_mode="auto")
CALLS = {"woodbury_ns": 3, "admm_segment": 8}
LONG_HORIZON = dict(control_horizon=13, use_joint_position_constraint=True)
N_TICKS = 120


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops on one thread: the test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def stream(device, horizon="paper"):
    replay = load_flight_replay(device=device)
    if horizon == "long":
        cfg = dataclasses.replace(replay.cfg, **LONG_HORIZON)
        replay = replay._replace(cfg=cfg, sched=build_schedule(cfg))
    return replay


def inputs(replay, batch, n_ticks):
    """Each tick's (snapshot, est_td) for ``batch`` lanes, lanes past the
    first with their momentum perturbed."""
    jitter = torch.as_tensor(
        0.1 * np.random.default_rng(0).standard_normal((batch, 6)),
        dtype=torch.float32, device=replay.est_td.device)
    jitter[0] = 0.0
    return [replay.tick_inputs(t, batch, jitter) for t in range(n_ticks)]


def chain(tick, replay, settings, problem, carry, ins):
    """(carry, outputs) of ``tick`` chained over ``ins``."""
    outs = []
    for snap, est in ins:
        carry, out = tick(replay.cfg, replay.sched, replay.sel, settings,
                          problem, carry, snap, est)
        outs.append((carry, out))
    return carry, outs


def eager(cfg, sched, sel, settings, problem, carry, snap, est):
    return mpc.condensed_tick(cfg, sched, sel, settings, problem, carry, snap,
                              est)


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


def tick_counts():
    return (mpc.mpc_tick.graphed_ticks, mpc.mpc_tick.graph_captures)


def recording(monkeypatch):
    """Every call of the two kernel wrappers, by name, from now on."""
    calls = {name: 0 for name in CALLS}
    for name in CALLS:
        f = getattr(kernels, name)

        def call(*args, _f=f, _name=name, **kwargs):
            calls[_name] += 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(kernels, name, functools.wraps(f)(call))
    return calls


# ---------------------------------------------------------------------------
# CPU: where no graph runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_stream():
    replay = stream("cpu")
    problem, carry = replay.configure(SETTINGS)
    return replay, problem, carry


@pytest.mark.parametrize("batch_guard", [False, True])
def test_cpu_tick_runs_eagerly(cpu_stream, batch_guard):
    """On the CPU, per-lane or batch-wide, ``mpc_tick`` is the eager tick:
    the same bits as the stages called directly, no graph captured or
    replayed."""
    replay, problem, carry = cpu_stream
    settings = dataclasses.replace(SETTINGS, batch_guard=batch_guard)
    ins = inputs(replay, 1, 2)
    before = tick_counts()
    _, got = chain(mpc.mpc_tick, replay, settings, problem, carry, ins)
    _, want = chain(eager, replay, settings, problem, carry, ins)
    assert tick_counts() == before
    assert same(got, want)


def test_cpu_tick_calls_the_kernels_through_their_module(cpu_stream,
                                                         monkeypatch):
    """Each kernel call looks its wrapper up in ``ops/kernels.py`` at the
    call, as a replay does: a wrapper swapped in sees 3 refresh and 8
    segment calls a tick."""
    replay, problem, carry = cpu_stream
    calls = recording(monkeypatch)
    chain(mpc.mpc_tick, replay, SETTINGS, problem, carry, inputs(replay, 1, 1))
    assert calls == CALLS


def _carry_on(device_type):
    return types.SimpleNamespace(
        warm_x=types.SimpleNamespace(device=torch.device(device_type)))


@pytest.mark.parametrize("solver, batch_guard, kernel_mode, device_type, "
                         "engages", [
                             ("condensed", False, "auto", "cuda", True),
                             ("condensed", False, "on", "cuda", True),
                             ("condensed", True, "auto", "cuda", False),
                             ("condensed", False, "off", "cuda", False),
                             ("full", False, "auto", "cuda", False),
                             ("condensed", False, "auto", "cpu", False),
                         ])
def test_graphs_engage_only_where_the_tick_reads_nothing_back(
        solver, batch_guard, kernel_mode, device_type, engages):
    """A graphed tick needs a condensed solve on the card with per-lane
    decisions and the kernels on: a batch-wide decision is a read on the
    host, and so is the unpadded refresh's ``torch.linalg.solve``."""
    cfg = dataclasses.replace(MPCConfig(), qp_solver=solver)
    settings = dataclasses.replace(SETTINGS, batch_guard=batch_guard,
                                   kernel_mode=kernel_mode)
    assert mpc._graphs_engage(cfg, settings, _carry_on(device_type)) is engages


def test_flat_outputs_hand_out_fresh_views_of_one_buffer_a_dtype(
        tmp_path):
    """A take is one clone a dtype, its tensors views of them: the written
    values, their dtypes and shapes, an aliased tensor still one, None
    kept; a second take shares no memory with the first; ``torch.save``
    takes it (a checkpoint of a carry)."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    n = torch.tensor([[3], [-4]], dtype=torch.int32)
    flag = torch.tensor([True, False])
    strided = torch.arange(16.0).reshape(4, 4)[:, 1:3]   # not contiguous
    tree = (mpc.MPCOutput(
        joints_pos_ref=x, throttle=x, thrust_des=x, thrust_dot_des=x,
        final_state=strided, status=n, pri_res=x, dua_res=x,
        alpha_gravity=x, pos_com_ref=x, rpy_ref=x, mom_ref=x,
        guard_fired=flag, debug=None), x)
    flat = graphs.FlatOutputs(tree)
    flat.write(tree)
    a, b = flat.take(), flat.take()
    assert same(a, tree)
    assert a[0].debug is None and type(a[0]) is mpc.MPCOutput
    assert a[0].joints_pos_ref is a[0].throttle is a[1]
    assert a[0].status.dtype == torch.int32 and a[0].status.shape == (2, 1)
    assert a[0].final_state.is_contiguous()
    assert a[1].untyped_storage().data_ptr() != \
        b[1].untyped_storage().data_ptr()
    assert len({t.untyped_storage().data_ptr()
                for t in graphs.leaves(a)}) == 3
    torch.save(graphs.leaves(a), tmp_path / "a.pt")
    assert same(torch.load(tmp_path / "a.pt"), graphs.leaves(tree))


def test_static_inputs_take_each_position_by_itself():
    """A tree aliased at capture may come apart later: every position has
    a buffer of its own, filled a dtype at a time."""
    x = torch.ones(3)
    tree = (x, x, torch.zeros(2, dtype=torch.int32), None)
    static = graphs.StaticInputs(tree)
    assert static.tree[3] is None and static.tree[0] is not static.tree[1]
    later = (torch.full((3,), 2.0), torch.full((3,), 5.0),
             torch.tensor([7, 8], dtype=torch.int32), None)
    static.copy_from(later)
    assert same(static.tree, later)


@pytest.mark.parametrize("metric", ["graphed_ticks_share.b1",
                                    "graphed_ticks_share.batched"])
def test_graphed_share_readers(metric):
    """100 × graphed ticks ÷ ticks of the window; None where the program
    keeps no such counter."""
    read = spec.metric_reader(metric)
    assert read(dict(ticks=80, counters={
        "qp.mpc.mpc_tick.graphed_ticks": 60})) == 75.0
    assert read(dict(ticks=80, counters={
        "qp.mpc.mpc_tick.graphed_ticks": 0})) == 0.0
    assert read(dict(ticks=80, counters={
        "qp.condensed.solve.iterations": 400})) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tick is graphed only on the "
                    "card")
    kernels.build()
    return {h: stream("cuda", h) for h in ("paper", "long")}


def configured(replay, batch, settings=SETTINGS):
    problem, carry = replay.configure(settings)
    return problem, expand_lanes(carry, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("horizon, batch", [("paper", 1), ("paper", 4),
                                            ("long", 1)])
def test_graphed_tick_equals_the_eager_tick(card, horizon, batch):
    """120 chained ticks: every tick's commands, status, terminal state and
    carry bit for bit as the eager tick's, every tick but the capture's a
    replay."""
    replay = card[horizon]
    problem, carry = configured(replay, batch)
    ins = inputs(replay, batch, N_TICKS)
    before = tick_counts()
    _, got = chain(mpc.mpc_tick, replay, SETTINGS, problem, carry, ins)
    after = tick_counts()
    _, want = chain(eager, replay, SETTINGS, problem, carry, ins)
    assert after == (before[0] + N_TICKS, before[1] + 1)
    for t, (g, w) in enumerate(zip(got, want)):
        assert same(g, w), f"tick {t}"
    status = torch.stack([o.status for _, o in got]).cpu()
    assert bool(torch.isin(status, torch.tensor([1, 2])).all())


@pytest.mark.gpu
def test_outputs_outlive_the_next_tick(card):
    """What a tick returned belongs to its caller: the next replay leaves
    it as it was."""
    replay = card["paper"]
    problem, carry = configured(replay, 1)
    ins = inputs(replay, 1, 3)
    carry, out = chain(mpc.mpc_tick, replay, SETTINGS, problem, carry,
                       ins[:2])[1][-1]
    kept = (tree_map(torch.clone, carry), tree_map(torch.clone, out))
    chain(mpc.mpc_tick, replay, SETTINGS, problem, carry, ins[2:])
    assert same((carry, out), kept)


@pytest.mark.gpu
def test_a_pass_restarted_from_a_saved_carry_repeats(card):
    """Passes from clones of one saved carry (new addresses each time) give
    the same bits, from the graphs captured once."""
    replay = card["paper"]
    problem, saved = configured(replay, 1)
    ins = inputs(replay, 1, 20)
    first = chain(mpc.mpc_tick, replay, SETTINGS, problem,
                  tree_map(torch.clone, saved), ins)[1]
    captures = mpc.mpc_tick.graph_captures
    again = chain(mpc.mpc_tick, replay, SETTINGS, problem,
                  tree_map(torch.clone, saved), ins)[1]
    assert mpc.mpc_tick.graph_captures == captures
    assert same(first, again)


@pytest.mark.gpu
def test_replay_calls_each_kernel_through_its_module(card, monkeypatch):
    """A wrapper swapped into ``ops/kernels.py`` after the capture is the
    one a replay calls: 3 refresh and 8 segment calls a tick."""
    replay = card["paper"]
    problem, carry = configured(replay, 1)
    ins = inputs(replay, 1, 3)
    carry, _ = chain(mpc.mpc_tick, replay, SETTINGS, problem, carry,
                     ins[:1])
    calls = recording(monkeypatch)
    graphed = mpc.mpc_tick.graphed_ticks
    chain(mpc.mpc_tick, replay, SETTINGS, problem, carry, ins[1:])
    assert mpc.mpc_tick.graphed_ticks == graphed + 2
    assert calls == {k: 2 * n for k, n in CALLS.items()}


@pytest.mark.gpu
def test_counters_move_as_on_the_eager_path(card):
    """``solve.iterations``, ``solve.refresh_skips`` and each kernel's
    ``launches`` move by what the eager tick moves them, the capturing call
    included."""
    replay = card["paper"]

    def moves(tick):
        problem, carry = configured(replay, 1)     # a new problem: a capture
        read = lambda: (condensed.solve.iterations,  # noqa: E731
                        condensed.solve.refresh_skips,
                        kernels.woodbury_ns.launches,
                        kernels.admm_segment.launches)
        start = read()
        chain(tick, replay, SETTINGS, problem, carry,
              inputs(replay, 1, 10))
        return [b - a for a, b in zip(start, read())]

    captures = mpc.mpc_tick.graph_captures
    graphed = moves(mpc.mpc_tick)
    assert mpc.mpc_tick.graph_captures == captures + 1
    assert graphed == moves(eager)
    assert graphed[2:] == [10 * CALLS["woodbury_ns"],
                           10 * CALLS["admm_segment"]]


@pytest.mark.gpu
def test_kernels_off_ticks_eagerly_on_the_card(card):
    """With the kernels off the long horizon's unpadded refresh reads its
    ``torch.linalg.solve`` back on the host: ``mpc_tick`` stays eager there
    and gives the stages' bits."""
    replay = card["long"]
    settings = dataclasses.replace(SETTINGS, kernel_mode="off")
    problem, carry = configured(replay, 1, settings)
    ins = inputs(replay, 1, 3)
    before = tick_counts()
    _, got = chain(mpc.mpc_tick, replay, settings, problem, carry, ins)
    assert tick_counts() == before
    assert same(got, chain(eager, replay, settings, problem, carry, ins)[1])
