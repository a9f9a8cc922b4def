"""The port's debug-log mode (``MPCConfig(enable_debug_log_mode=True)``)
against the JAX package's.

With the flag on, every tick emits a :class:`DebugInfo`: the per-block
½xᵀH_b x + g_bᵀx costs and the lb ≤ Ax ≤ ub triples of the reference's
constraint stack, zeroed on lanes that did not solve
(IMPCProblem.cpp:300-408). Held here, on the first recorded flight ticks:
the port's DebugInfo against JAX's under both solvers; the flag off gives
None; the two solvers minimise the same QP, so their block costs agree
within 1e-2 of scale (the bound of tests/test_aux_subsystems.py::
test_debug_log_mode); and the closed loop's telemetry carries the
DebugInfo through ``tick`` and ``rollout`` in the [T, B, ...] layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ironcub_mpc_tpu.horizon import schedule as jschedule
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.qp import mpc as jmpc
from ironcub_mpc_tpu.runtime.replay import load_flight_replay as jload

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.core.types import DebugInfo, expand_lanes
from ironcub_mpc_tpu_torch.horizon import schedule as tschedule
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.qp import mpc as tmpc
from ironcub_mpc_tpu_torch.runtime import flight
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay as tload

from test_torch_tick import _close, _np, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
SOLVERS = ("condensed", "full")
# the settings of tests/test_aux_subsystems.py::test_debug_log_mode
JSET = jadmm.ADMMSettings(max_iter=120, pallas_mode="off")
TSET = tadmm.ADMMSettings(max_iter=120, kernel_mode="off")
N_TICKS = 2


def _with(replay, schedule, **over):
    cfg = dataclasses.replace(replay.cfg, **over)
    return replay._replace(cfg=cfg, sched=schedule.build_schedule(cfg))


@pytest.fixture(scope="module")
def runs():
    """N_TICKS recorded ticks under each solver with the flag on: JAX's
    outputs and the port's, from the same configured state, at batch 1 and
    at batch 3 (identical lanes)."""
    out = {}
    for solver in SOLVERS:
        over = dict(qp_solver=solver, enable_debug_log_mode=True)
        jr, tr = _with(jload(), jschedule, **over), \
            _with(tload(device="cpu"), tschedule, **over)
        problem, carry = jr.configure(JSET)
        step = jax.jit(lambda c, s, e, jr=jr, problem=problem: jmpc.mpc_tick(
            jr.cfg, jr.sched, jr.sel, JSET, problem, c, s, e))
        tp = convert.problem_from_numpy(_np(problem), CPU)
        tc = convert.carry_from_numpy(_np(carry), CPU)
        tc3 = expand_lanes(tc, 3)
        jo_s, to_s, to3_s = [], [], []
        for t in range(N_TICKS):
            carry, jo = step(carry, jr.snap_of(t + 1), jr.est_td[t])
            tc, to = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, TSET, tp, tc,
                                   *tr.tick_inputs(t))
            tc3, to3 = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, TSET, tp, tc3,
                                     *tr.tick_inputs(t, 3))
            jo_s.append(_np(jo))
            to_s.append(to)
            to3_s.append(to3)
        out[solver] = (jo_s, to_s, to3_s)
    return out


@pytest.mark.parametrize("solver", SOLVERS)
def test_debug_info_matches_jax(runs, solver):
    """Every DebugInfo field against JAX's, tick by tick: the bounds and
    Ax to 1e-5 of their largest entry; the block costs and their total to
    1e-4 relative, the tolerance of the condensed solve's iterate against
    JAX's (tests/test_torch_tick.py::test_solve_matches_jax; measured here
    up to 1.1e-5, in the joint-regularisation block, a sum of 65000·Δq²)."""
    for t, (jo, to) in enumerate(zip(*runs[solver][:2])):
        assert int(to.status[0]) == int(jo.status) == tadmm.SOLVED
        jd, td = jo.debug, to.debug
        assert isinstance(td, DebugInfo)
        for name in ("constraint_lb", "constraint_ax", "constraint_ub"):
            _close(getattr(td, name)[0].numpy(), getattr(jd, name), 1e-5,
                   f"{name}, tick {t}")
        np.testing.assert_allclose(td.block_costs[0].numpy(), jd.block_costs,
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"block_costs, tick {t}")
        np.testing.assert_allclose(float(td.total_cost[0]),
                                   float(jd.total_cost), rtol=1e-4)


@pytest.mark.parametrize("solver", SOLVERS)
def test_debug_info_is_consistent_and_feasible(runs, solver):
    """The checks of test_debug_log_mode on the port's output, at batch 1
    and on every lane of batch 3: [B, ...] shapes, the accepted solution
    inside every row's bounds, the total the sum of the blocks."""
    m = runs[solver][1][0].debug.constraint_lb.shape[-1]
    for to in runs[solver][1] + runs[solver][2]:
        dbg = to.debug
        B = to.status.shape[0]
        assert dbg.block_costs.shape == (B, 4)
        assert dbg.total_cost.shape == (B,)
        for name in ("constraint_lb", "constraint_ax", "constraint_ub"):
            assert getattr(dbg, name).shape == (B, m)
        for v in dbg:
            assert torch.isfinite(v).all()
        ax, lb, ub = (getattr(dbg, k).double().numpy() for k in
                      ("constraint_ax", "constraint_lb", "constraint_ub"))
        scale = np.maximum(np.abs(lb), 1.0)
        assert np.all(ax >= lb - 5e-3 * scale), (ax - lb).min()
        assert np.all(ax <= ub + 5e-3 * scale), (ub - ax).min()
        np.testing.assert_allclose(dbg.total_cost.numpy(),
                                   dbg.block_costs.sum(-1).numpy(), rtol=1e-6)
    # identical lanes of the batch carry the batch-1 payload, to the
    # rounding of batched against single products (1.3e-5 relative measured
    # in the block costs)
    for to, to3 in zip(runs[solver][1], runs[solver][2]):
        for name, a, b in zip(DebugInfo._fields, to.debug, to3.debug):
            _close(b.numpy(), a.expand_as(b).numpy(), 1e-4, name)


def test_two_solvers_agree_on_block_costs(runs):
    """Both solvers minimise the same QP: their block costs agree within
    1e-2 of scale, tick by tick (as JAX's own, which the second line
    checks)."""
    for t in range(N_TICKS):
        full = runs["full"][1][t].debug.block_costs[0].double().numpy()
        cond = runs["condensed"][1][t].debug.block_costs[0].double().numpy()
        scale = max(np.abs(full).max(), 1.0)
        assert np.abs(cond - full).max() / scale < 1e-2, (t, cond, full)
        jf = runs["full"][0][t].debug.block_costs.astype(np.float64)
        jc = runs["condensed"][0][t].debug.block_costs.astype(np.float64)
        assert np.abs(jc - jf).max() / scale < 1e-2


def test_flag_off_emits_nothing():
    """Without the flag no DebugInfo is built, under either solver."""
    for solver in SOLVERS:
        tr = _with(tload(device="cpu"), tschedule, qp_solver=solver)
        problem, carry = tr.configure(TSET)
        _, out = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, TSET, problem,
                               carry, *tr.tick_inputs(0))
        assert out.debug is None


def test_unsolved_lane_reports_zeros():
    """A lane that does not solve keeps its bounds but reports zero costs
    and zero Ax (IMPCProblem.cpp:300-408)."""
    tr = _with(tload(device="cpu"), tschedule, enable_debug_log_mode=True)
    problem, carry = tr.configure(TSET)
    # two iterations cannot reach eps: MAX_ITER_REACHED
    settings = tadmm.ADMMSettings(max_iter=2, polish=False,
                                  rho_update_iters=(), kernel_mode="off")
    _, out = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, settings, problem,
                           carry, *tr.tick_inputs(0))
    assert int(out.status[0]) == tadmm.MAX_ITER_REACHED
    assert torch.count_nonzero(out.debug.block_costs) == 0
    assert torch.count_nonzero(out.debug.constraint_ax) == 0
    assert torch.count_nonzero(out.debug.constraint_lb) > 0


def test_rollout_carries_debug_info():
    """The closed loop with the flag on: each tick's telemetry carries the
    DebugInfo, and ``rollout`` stacks it [T, B, ...] like every channel;
    with the flag off the field stays None."""
    loop, pos, alpha = flight.build_flight_loop(device="cpu")
    settled = loop.settle(flight.standing_state(
        loop.plant, loop.plant.sim_cfg.initial_position_deg, batch=2), 0.02)
    channels, alpha = flight.mission_inputs(pos, alpha)
    dbg_loop = ClosedLoop(loop.plant, dataclasses.replace(
        loop.cfg, enable_debug_log_mode=True), loop.settings)
    problem, carry = dbg_loop.configure(settled, channels, alpha)
    _, tel = dbg_loop.rollout(problem, carry, 3)
    m = loop.cfg.n_constraints
    assert tel.debug.block_costs.shape == (3, 2, 4)
    assert tel.debug.constraint_ax.shape == (3, 2, m)
    _, tel1 = dbg_loop.tick(problem, carry)
    for a, b in zip(tel.debug, tel1.debug):
        np.testing.assert_array_equal(a[0].numpy(), b.numpy())
    solved = (tel.solver_status == 1) | (tel.solver_status == 2)
    assert bool(solved.all())
    np.testing.assert_allclose(tel.debug.total_cost.numpy(),
                               tel.debug.block_costs.sum(-1).numpy(),
                               rtol=1e-6)
    back = convert.to_numpy(tel.debug)
    assert isinstance(back, DebugInfo) and back.total_cost.shape == (3, 2)
    problem, carry = loop.configure(settled, channels, alpha)
    _, tel = loop.rollout(problem, carry, 1)
    assert tel.debug is None
