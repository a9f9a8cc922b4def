"""The port's own spans and counters inside the condensed MPC tick, on the
CPU with ``kernel_mode="off"``.

With no profiler running a tick enters no ``record_function`` and gives
the same bits as under the profiler; under it each tick is one
``mpc.tick`` span with ``mpc.prep`` / ``mpc.condense`` / ``mpc.solve`` /
``mpc.finish`` as disjoint children in that order and the ``solve.*``
stages inside ``mpc.solve``. The host counters of ``qp/condensed.py``
``solve``: ``iterations`` (ADMM iterations launched for the batch) and
``refresh_skips`` (batch-wide refreshes that carried K⁻¹ untouched).
Imports no JAX; the hover problem of ``tools/common_torch.batched_hover``
at three lanes.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.qp import condensed
from ironcub_mpc_tpu_torch.qp import mpc
from ironcub_mpc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from common_torch import batched_hover  # noqa: E402

# the benchmark's solver (mpcbench/configs/mk3_paper.json), per-lane
SETTINGS = admm.ADMMSettings(max_iter=40, rho_update_iters=(15,),
                             ns_skip_tol=0.02, term_check_every=5,
                             kernel_mode="off")
TICK_STAGES = ("mpc.prep", "mpc.condense", "mpc.solve", "mpc.finish")
SOLVE_STAGES = ("solve.scale", "solve.refresh", "solve.iterate",
                "solve.polish", "solve.status")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops on one thread: the test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hover():
    """(cfg, sched, sel, problem, carry, snaps, est) of three lanes, the
    carry one tick past configure."""
    cfg, sched, sel, _, problem, carry, snaps, est = batched_hover(
        3, SETTINGS, device="cpu")
    carry, _ = mpc.mpc_tick(cfg, sched, sel, SETTINGS, problem, carry, snaps,
                            est)
    return cfg, sched, sel, problem, carry, snaps, est


def tick(hover, settings, carry=None):
    cfg, sched, sel, problem, carry0, snaps, est = hover
    return mpc.mpc_tick(cfg, sched, sel, settings, problem,
                        carry0 if carry is None else carry, snaps, est)


def leaves(out):
    carry, o = out
    return [t for t in (*carry, *o) if isinstance(t, torch.Tensor)]


def moves(fn):
    """How far ``solve.iterations`` and ``solve.refresh_skips`` move over
    ``fn()``."""
    it, sk = condensed.solve.iterations, condensed.solve.refresh_skips
    fn()
    return (condensed.solve.iterations - it,
            condensed.solve.refresh_skips - sk)


@pytest.mark.parametrize("batch_guard", [False, True])
def test_no_profiler_enters_no_record_function(hover, monkeypatch,
                                               batch_guard):
    settings = dataclasses.replace(SETTINGS, batch_guard=batch_guard)
    rf = torch.autograd.profiler.record_function
    entered = []
    init, enter = rf.__init__, rf.__enter__

    def counting_init(self, name, *args, **kwargs):
        entered.append(name)
        init(self, name, *args, **kwargs)

    def counting_enter(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(rf, "__init__", counting_init)
    monkeypatch.setattr(rf, "__enter__", counting_enter)
    assert profiling.span("a") is profiling.span("b")
    off = tick(hover, settings)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = tick(hover, settings)
    assert "mpc.tick" in entered and "solve.iterate" in entered
    a, b = leaves(off), leaves(on)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_spans_nest_one_tree_a_tick(hover):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry, _ = tick(hover, SETTINGS)
        tick(hover, SETTINGS, carry)
    ours = [e for e in prof.events()
            if e.name.startswith(("mpc.", "solve."))]
    ticks = sorted((e for e in ours if e.name == "mpc.tick"),
                   key=lambda e: e.time_range.start)
    assert len(ticks) == 2

    def inside(outer, e):
        return (outer.time_range.start <= e.time_range.start
                and e.time_range.end <= outer.time_range.end)

    def children(outer, names):
        got = sorted((e for e in ours if e.name in names and inside(outer, e)),
                     key=lambda e: e.time_range.start)
        assert [e.name for e in got] == list(names)
        for a, b in zip(got, got[1:]):
            assert a.time_range.end <= b.time_range.start
        return got

    for t in ticks:
        stages = children(t, TICK_STAGES)
        children(stages[2], SOLVE_STAGES)
    # every span of the two ticks lies in one of them
    assert all(any(inside(t, e) for t in ticks) for e in ours)
    assert len(ours) == 2 * (1 + len(TICK_STAGES) + len(SOLVE_STAGES))


def test_per_lane_iterations_are_max_iter_a_tick(hover):
    its, skips = moves(lambda: tick(hover, SETTINGS))
    assert (its, skips) == (SETTINGS.max_iter, 0)


def test_iterations_count_the_chunks_the_gate_let_run(hover, monkeypatch):
    settings = dataclasses.replace(SETTINGS, batch_guard=True)
    gates = []
    real = condensed.batch_any

    def counting(flag):
        out = real(flag)
        if sys._getframe(1).f_code.co_name == "run_segment_early":
            gates.append(out)
        return out

    counting.syncs = 0                  # batch_any counts on its module name
    monkeypatch.setattr(condensed, "batch_any", counting)
    ce = settings.term_check_every
    carry, its = None, []
    for _ in range(3):
        n0, g0 = condensed.solve.iterations, len(gates)
        carry, _ = tick(hover, settings, carry)
        ran = 1 + sum(gates[g0:])       # the solve's first chunk always runs
        its.append(condensed.solve.iterations - n0)
        assert its[-1] == ce * ran
        assert len(gates) - g0 == settings.max_iter // ce - 1
    assert min(its) < settings.max_iter, its   # the gate did skip chunks


@pytest.mark.parametrize("case, skips", [("inside", 1), ("outside", 0),
                                         ("per_lane", 0)])
def test_refresh_skip_counts_a_carried_inverse_inside_the_tolerance(
        hover, case, skips):
    cfg, sched, sel, problem, carry, snaps, est = hover
    carry, prep = mpc._tick_prep(cfg, sel, problem, carry, snaps, est)
    qp = mpc.condense_from_prep(cfg, sched, sel, problem, carry, prep)[0]
    settings = dataclasses.replace(SETTINGS, batch_guard=case != "per_lane")
    # the exact inverse of this QP's K(ρ), with its own scaling and ρ
    scaling, kinv, rho_vec, rho_scalar = condensed.setup(cfg, qp, settings)
    if case == "outside":
        kinv = 1.05 * kinv              # probe residual 0.05 > ns_skip_tol

    def solve():
        condensed.solve(cfg, qp, settings, scaling=scaling, kinv_prev=kinv,
                        rho_prev=rho_vec, rho_scalar_prev=rho_scalar)

    assert moves(solve)[1] == skips
