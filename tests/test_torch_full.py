"""The port's full-space MPC QP (``MPCConfig(qp_solver="full")``) against
the float64 oracle and the JAX package.

- Assembly: gradient and constraint stack of every case of
  tests/golden/golden_qp.npz, at the tolerances of
  tests/test_golden_qp.py::test_full_space_qp_matches_golden.
- Solve: a float64 KKT certificate of the port's solve of each oracle QP
  (the oracle's H, g, A, lb, ub), beside JAX's certificate of its own
  solve.
- ``configure``: the Ruiz scaling of the first assembled QP against JAX's.
- The tick: ``mpc_tick`` on the recorded stream at batch 1 (the JAX problem
  and carry carried across with ``convert``) and at batch 4 with numpy
  lane jitter, lane for lane against JAX's unbatched tick.
- NaN warm start recovery, the mirror of
  tests/test_condensed.py::test_full_space_warm_start_recovery.

Batch 4 is held against JAX's unbatched tick on each lane, not against
``jax.vmap``: JAX's own vmapped full tick parts from its unbatched tick
(``test_jax_vmapped_full_tick_spread``, slow, prints it), while the full
solver takes no batch-wide decision and the port's batched lanes follow the
unbatched JAX tick.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.core.config import MPCConfig as JMPCConfig
from ironcub_mpc_tpu.core.config import RobotConfig as JRobotConfig
from ironcub_mpc_tpu.core.config import joint_selector as jjoint_selector
from ironcub_mpc_tpu.horizon import schedule as jschedule
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.qp import mpc as jmpc
from ironcub_mpc_tpu.runtime.replay import load_flight_replay as jload

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.core.types import expand_lanes
from ironcub_mpc_tpu_torch.horizon import schedule as tschedule
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.qp import assembly as tassembly
from ironcub_mpc_tpu_torch.qp import mpc as tmpc
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay as tload

from helpers import make_hover_snapshot, make_test_trajectories
from test_golden_qp import _cases, _mpc_config
from test_torch_tick import (_close, _np, _port_cfg, _port_linearized, _t,
                             one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
FULL = dict(qp_solver="full")
N_TICKS = 4
# the tolerances of tests/test_torch_tick.py's batch-1 tick. Measured, port
# against JAX's unbatched tick over the first 20 recorded ticks at batch 4
# (the slow test below prints it): throttle 7.6e-6 %, joints 6e-8 rad,
# thrust_des 0, final_state 4.0e-7 of its largest entry, no status
# differing.
TOL = dict(joints=1e-4, throttle=1e-3, thrust_des=1e-3, final_state=2e-5)


# ---------------------------------------------------------------------------
# assembly against the float64 oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,d,ocfg,out", _cases(),
                         ids=lambda v: f"case{v}" if isinstance(v, int) else "")
def test_full_space_qp_matches_golden(k, d, ocfg, out):
    jcfg = _mpc_config(d, ocfg)
    cfg = _port_cfg(jcfg)
    sched = tschedule.build_schedule(cfg)
    f = lambda a: _t(np.asarray(a, np.float32))            # noqa: E731

    _close(tassembly.build_hessian(cfg), out["H"], 1e-9, "H")
    state_ref = tassembly.build_state_reference(
        cfg, f(d["win_pos"]), f(d["win_lin"]), f(d["win_rpy"]),
        f(d["win_ang"]))
    _close(state_ref[0].numpy(), out["state_ref"], 1e-6, "state_ref")
    Q = torch.as_tensor(tassembly.state_weight_matrix(cfg), dtype=torch.float32)
    g = tassembly.build_gradient(cfg, Q, state_ref, f(d["joint_pos_ctrl"]),
                                 f(d["joint_pos_ref_ctrl"]),
                                 f(d["throttle_cmd"]))
    _close(g[0].numpy(), out["g"], 2e-6, "g")

    lin = _port_linearized(cfg, d)
    A, lb, ub = tassembly.assemble_constraints(
        cfg, sched, lin, f(out["x0"]),
        torch.tensor([bool(d["pin_first_knot"])]), f(d["throttle_cmd"]))
    _close(A[0].numpy(), out["A"], 2e-5, "A")
    _close(lb[0].numpy(), out["lb"], 2e-5, "lb")
    _close(ub[0].numpy(), out["ub"], 2e-5, "ub")


def test_joint_position_rows_match_jax():
    """The joint-limit rows (off in the golden cases): every control knot
    boxed, the declared rows past the horizon 0 ≤ 0 ≤ 0."""
    from ironcub_mpc_tpu.qp import assembly as jassembly

    jcfg = dataclasses.replace(JMPCConfig(), use_joint_position_constraint=True)
    cfg = _port_cfg(jcfg)
    jp = np.random.default_rng(0).uniform(-1, 1, 8).astype(np.float32)
    jA, jl, ju = jassembly.build_joint_position_rows(jcfg, jnp.asarray(jp),
                                                     jnp.float32)
    A, lb, ub = tassembly.build_joint_position_rows(cfg, _t(jp), torch.float32)
    for got, want in ((A, jA), (lb, jl), (ub, ju)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


# one compile for every case (they share the stock shape)
_jsolve = jax.jit(lambda *qp: jadmm.solve(*qp, jadmm.ADMMSettings()))


@pytest.mark.parametrize("k,d,ocfg,out", _cases(),
                         ids=lambda v: f"case{v}" if isinstance(v, int) else "")
def test_full_space_solve_kkt_certificate(k, d, ocfg, out):
    """The port's solve of the oracle's QP, certified in float64 against the
    oracle's H, g, A, lb, ub: stationarity, primal feasibility,
    complementary slackness. JAX's solve of the same float32 QP is held to
    the same bounds, so the bounds are the solver's, not the port's."""
    H, g, A, lb, ub = (out[k_] for k_ in ("H", "g", "A", "lb", "ub"))
    f32 = [np.asarray(a, np.float32) for a in (H, g, A, lb, ub)]
    jsol = _jsolve(*(jnp.asarray(a) for a in f32))
    tsol = tadmm.solve(*(torch.as_tensor(a)[None] for a in f32),
                       tadmm.ADMMSettings())
    assert int(tsol.status[0]) == int(jsol.status) == tadmm.SOLVED

    def certificate(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        station = np.abs(H @ x + g + A.T @ y).max() / max(np.abs(g).max(), 1)
        ax = A @ x
        scale = np.maximum(np.abs(lb), 1.0)
        infeas = max((lb - ax).max(), (ax - ub).max(), 0.0)
        ineq = (ub - lb) > 1e-9
        z = np.clip(ax, lb, ub)
        comp = max(np.abs(np.maximum(y, 0) * (ub - z))[ineq].max(),
                   np.abs(np.minimum(y, 0) * (z - lb))[ineq].max())
        return station, infeas / scale.max(), comp

    port = certificate(tsol.x[0].numpy(), tsol.y[0].numpy())
    ref = certificate(jsol.x, jsol.y)
    # OSQP's eps 1e-3 (absolute + relative) on the Ruiz-scaled residuals
    for name, got, want, bound in zip(("stationarity", "infeasibility",
                                       "complementarity"), port, ref,
                                      (2e-3, 1e-3, 5e-2)):
        assert want < bound, f"JAX {name} {want:.3e} >= {bound}"
        assert got < bound, f"port {name} {got:.3e} >= {bound}"
    _close(tsol.x[0].numpy(), np.asarray(jsol.x), 1e-4, "x")


# ---------------------------------------------------------------------------
# configure and the tick on the recorded stream
# ---------------------------------------------------------------------------


def _full(replay, schedule):
    cfg = dataclasses.replace(replay.cfg, **FULL)
    return replay._replace(cfg=cfg, sched=schedule.build_schedule(cfg))


@pytest.fixture(scope="module")
def stream():
    """The recorded stream under the full-space solver on both sides, and
    the JAX problem and carry configured from its frame 0."""
    jr, tr = _full(jload(), jschedule), _full(tload(device="cpu"), tschedule)
    problem, carry = jr.configure(jadmm.ADMMSettings())
    step = jax.jit(lambda c, s, e: jmpc.mpc_tick(
        jr.cfg, jr.sched, jr.sel, jadmm.ADMMSettings(), problem, c, s, e))
    return jr, tr, problem, carry, step


def test_configure_matches_jax(stream):
    """Ruiz on the first assembled QP: the problem's d, e, c; a carry whose
    warm start spans the full decision vector and the constraint rows, with
    no carried inverse."""
    jr, tr, problem, carry, _ = stream
    tp, tc = tr.configure(tadmm.ADMMSettings())
    for name in ("d", "e", "c"):
        _close(getattr(tp.scaling, name).numpy(),
               np.asarray(getattr(problem.scaling, name)), 1e-6, name)
    assert tp.cond_scaling is None and tc.kinv is None
    assert tc.warm_x.shape == (1, tr.cfg.n_var)
    assert tc.warm_y.shape == (1, tr.cfg.n_constraints)
    jc = _np(carry)
    for name in ("pos_com_ref", "rpy_ref", "mom_ref_now", "thrust_des",
                 "joints_pos_ref", "warm_x", "warm_y"):
        _close(getattr(tc, name)[0].numpy(), getattr(jc, name), 1e-6, name)


def _check(t, jouts, to, tc=None, jcs=None):
    """Lane b of the port's output against JAX's unbatched output b."""
    for b, jo in enumerate(jouts):
        assert int(to.status[b]) == int(jo.status), f"status, tick {t} lane {b}"
        for name, atol in (("joints_pos_ref", TOL["joints"]),
                           ("throttle", TOL["throttle"]),
                           ("thrust_des", TOL["thrust_des"])):
            np.testing.assert_allclose(
                getattr(to, name)[b].numpy(), np.asarray(getattr(jo, name)),
                rtol=0, atol=atol, err_msg=f"{name}, tick {t} lane {b}")
        _close(to.final_state[b].numpy(), np.asarray(jo.final_state),
               TOL["final_state"], f"final_state, tick {t} lane {b}")
        assert not bool(to.guard_fired[b])
    if tc is not None:
        for b, jc in enumerate(jcs):
            _close(tc.warm_x[b].numpy(), np.asarray(jc.warm_x), 1e-4,
                   f"warm_x, tick {t} lane {b}")


def test_tick_batch1_matches_jax(stream):
    """The JAX problem and carry carried across as numpy: the same ticks."""
    jr, tr, problem, carry, step = stream
    tp = convert.problem_from_numpy(_np(problem), CPU)
    tc = convert.carry_from_numpy(_np(carry), CPU)
    assert tp.cond_scaling is None and tc.kinv is None
    jc = carry
    settings = tadmm.ADMMSettings()
    for t in range(N_TICKS):
        jc, jo = step(jc, jr.snap_of(t + 1), jr.est_td[t])
        tc, to = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, settings, tp, tc,
                               *tr.tick_inputs(t))
        assert int(to.status[0]) == tadmm.SOLVED
        _check(t, [_np(jo)], to, tc, [_np(jc)])
    assert to.debug is None


def test_tick_batch4_matches_jax_lane_by_lane(stream):
    """Four lanes with momentum jitter (numpy, seeded): each lane of the
    port's batched tick against JAX's unbatched tick of the same lane."""
    jr, tr, problem, carry, step = stream
    B = 4
    jitter = (0.1 * np.random.default_rng(0).standard_normal((B, 6))
              ).astype(np.float32)
    tp = convert.problem_from_numpy(_np(problem), CPU)
    tc = expand_lanes(convert.carry_from_numpy(_np(carry), CPU), B)
    jcs = [carry] * B
    settings = tadmm.ADMMSettings()
    for t in range(N_TICKS):
        snap = jr.snap_of(t + 1)
        jouts = []
        for b in range(B):
            jcs[b], jo = step(jcs[b], snap._replace(
                momentum_body=snap.momentum_body + jitter[b]), jr.est_td[t])
            jouts.append(_np(jo))
        tc, to = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, settings, tp, tc,
                               *tr.tick_inputs(t, B, torch.as_tensor(jitter)))
        _check(t, jouts, to)


@pytest.mark.slow
def test_jax_vmapped_full_tick_spread(stream):
    """Prints the spread the tolerances above rest on: over the first 20
    recorded ticks at batch 4, JAX's vmapped full tick against its
    unbatched tick on the same lanes, and the port's batched tick against
    both. Slow: 80 unbatched and 20 vmapped JAX ticks (about 60 s on the
    CPU). Measured: JAX vmapped against unbatched, 5 of 80 lane-ticks
    MAX_ITER_REACHED where the unbatched tick solves, final_state 2.8e-2,
    joints 1.2e-3 rad, thrust_des 0.145 N, throttle 1.2e-4 %; the port
    against the unbatched tick, no status differing, final_state 4.0e-7,
    joints 6e-8 rad, thrust_des 0, throttle 7.6e-6 %."""
    jr, tr, problem, carry, step = stream
    B, n = 4, 20
    jitter = (0.1 * np.random.default_rng(0).standard_normal((B, 6))
              ).astype(np.float32)
    vstep = jax.jit(jax.vmap(lambda c, s, e: jmpc.mpc_tick(
        jr.cfg, jr.sched, jr.sel, jadmm.ADMMSettings(), problem, c, s, e)))
    tp = convert.problem_from_numpy(_np(problem), CPU)
    tc = expand_lanes(convert.carry_from_numpy(_np(carry), CPU), B)
    jcs = [carry] * B
    jcv = jax.tree.map(lambda a: jnp.stack([a] * B), carry)
    keys = ("throttle", "joints_pos_ref", "thrust_des", "final_state")
    worst = {p: dict.fromkeys(keys + ("status",), 0.0)
             for p in ("vmap-unbatched", "port-unbatched", "port-vmap")}
    for t in range(n):
        snap = jr.snap_of(t + 1)
        one = []
        for b in range(B):
            jcs[b], jo = step(jcs[b], snap._replace(
                momentum_body=snap.momentum_body + jitter[b]), jr.est_td[t])
            one.append(_np(jo))
        sv = jax.tree.map(lambda a: jnp.stack([a] * B), snap)
        sv = sv._replace(momentum_body=sv.momentum_body + jitter)
        jcv, ov = vstep(jcv, sv, jnp.stack([jr.est_td[t]] * B))
        tc, to = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, tadmm.ADMMSettings(),
                               tp, tc, *tr.tick_inputs(
                                   t, B, torch.as_tensor(jitter)))
        outs = {"unbatched": {k: np.stack([np.asarray(getattr(o, k))
                                           for o in one])
                              for k in keys + ("status",)},
                "vmap": {k: np.asarray(getattr(ov, k))
                         for k in keys + ("status",)},
                "port": {k: getattr(to, k).numpy()
                         for k in keys + ("status",)}}
        for pair in worst:
            a, b = (outs[s] for s in pair.split("-"))
            w = worst[pair]
            w["status"] += float((a["status"] != b["status"]).sum())
            for k in keys[:3]:
                w[k] = max(w[k], float(np.abs(a[k] - b[k]).max()))
            w["final_state"] = max(w["final_state"], float(
                (np.abs(a["final_state"] - b["final_state"]).max(-1)
                 / np.maximum(np.abs(b["final_state"]).max(-1), 1)).max()))
    print(f"\nfull tick, batch {B}, {n} recorded ticks: {worst}")
    assert worst["port-unbatched"]["status"] == 0
    for k, lim in (("throttle", TOL["throttle"]),
                   ("joints_pos_ref", TOL["joints"]),
                   ("thrust_des", TOL["thrust_des"]),
                   ("final_state", TOL["final_state"])):
        assert worst["port-unbatched"][k] < lim, (k, worst)


# ---------------------------------------------------------------------------
# recovery from a failed tick
# ---------------------------------------------------------------------------


def test_full_space_warm_start_recovery():
    """NaN warm start and duals from a failed tick are sanitised: the next
    tick solves and gives the commands of a clean one, on both sides."""
    jcfg = dataclasses.replace(JMPCConfig(), **FULL)
    cfg = _port_cfg(jcfg)
    sched = tschedule.build_schedule(cfg)
    jsched = jschedule.build_schedule(jcfg)
    sel = jjoint_selector(JRobotConfig(), jcfg)
    snap = make_hover_snapshot()
    channels, alpha = make_test_trajectories()
    js, ts = jadmm.ADMMSettings(max_iter=200), tadmm.ADMMSettings(max_iter=200)
    problem, carry = jmpc.configure(jcfg, jsched, sel, snap, channels, alpha,
                                    js)
    carry, ref_out = jmpc.mpc_tick(jcfg, jsched, sel, js, problem, carry,
                                   snap, jnp.zeros(4))
    bad = carry._replace(warm_x=jnp.full_like(carry.warm_x, jnp.nan),
                         warm_y=jnp.full_like(carry.warm_y, jnp.nan))
    _, jout = jmpc.mpc_tick(jcfg, jsched, sel, js, problem, bad, snap,
                            jnp.zeros(4))

    tsnap = convert.snapshot_from_numpy(_np(snap), CPU)
    tp, tc = tmpc.configure(cfg, sched, sel, tsnap, channels, alpha, ts,
                            device="cpu")
    est = torch.zeros((1, 4))
    tc, tref = tmpc.mpc_tick(cfg, sched, sel, ts, tp, tc, tsnap, est)
    tbad = tc._replace(warm_x=torch.full_like(tc.warm_x, float("nan")),
                       warm_y=torch.full_like(tc.warm_y, float("nan")))
    _, tout = tmpc.mpc_tick(cfg, sched, sel, ts, tp, tbad, tsnap, est)
    assert int(tout.status[0]) in (tadmm.SOLVED, tadmm.SOLVED_INACCURATE)
    assert int(tout.status[0]) == int(jout.status)
    np.testing.assert_allclose(tout.throttle[0].numpy(),
                               tref.throttle[0].numpy(), atol=1e-3)
    np.testing.assert_allclose(tref.throttle[0].numpy(),
                               np.asarray(ref_out.throttle), atol=1e-3)
    np.testing.assert_allclose(tout.joints_pos_ref[0].numpy(),
                               np.asarray(jout.joints_pos_ref), atol=1e-4)
