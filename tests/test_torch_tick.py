"""The port's condensed multi-rate MPC tick against the JAX package.

Each stage of the slice is held against its JAX counterpart on the same
inputs: the linearisation (also against tests/golden/golden_qp.npz), the
condensing, the solver setup and the box-QP solve, ``configure`` from the
recorded flight stream, and then the slice as a whole — the port's
``mpc_tick`` on the CPU against the JAX ``mpc_tick``, both starting from the
same state carried across with ``ironcub_mpc_tpu_torch.convert``:

- batch 1 on the kernel layout (``kernel_mode="on"`` against
  ``pallas_mode="on"``, the Pallas kernels in interpret mode), per-lane
  decisions (``batch_guard=False`` against ``guard_axis=None``);
- batch 4 with the bench settings (``batch_guard=True`` against
  ``guard_axis=BATCH_GUARD_AXIS`` under ``jax.vmap``, unpadded layout) over
  the first 20 replay ticks, with numpy lane jitter on the momentum.

``status`` and ``guard_fired`` must be equal lane for lane on every tick.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.horizon import schedule as jschedule
from ironcub_mpc_tpu.qp import condensed as jcond
from ironcub_mpc_tpu.qp import mpc as jmpc
from ironcub_mpc_tpu.runtime.replay import load_flight_replay as jload

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.core import config as tconfig
from ironcub_mpc_tpu_torch.core.types import RobotSnapshot, expand_lanes
from ironcub_mpc_tpu_torch.horizon import schedule as tschedule
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.qp import condensed as tcond
from ironcub_mpc_tpu_torch.qp import mpc as tmpc
from ironcub_mpc_tpu_torch.qp.blocks import LambdaInit
from ironcub_mpc_tpu_torch.qp.blocks import linearize as tlinearize
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay as tload

from test_golden_qp import _amom_body, _cases, _linearized, _mpc_config

CPU = torch.device("cpu")

# bench.py:84-89, the settings of the measured regime
BENCH = dict(max_iter=40, polish=True, rho_update_iters=(15,),
             kinv_guard=True, ns_skip_tol=0.02, term_check_every=5)


def _port_cfg(jcfg):
    """The port's MPCConfig with every field of a JAX-package config."""
    return tconfig.MPCConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg)})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, batch=True):
    t = torch.as_tensor(np.array(a))
    return t[None] if batch else t


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's eager PyTorch on one thread. With several test
    processes sharing the cores (pytest-xdist), PyTorch's default of a
    thread per core makes each of a tick's thousands of small ops wait for
    threads that are not scheduled: about ten times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _close(got, want, tol, what):
    """Max error normalised by the reference's largest magnitude (at least
    1), as tests/test_golden_qp.py measures it."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64).reshape(got.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err < tol, f"{what}: normalized max err {err:.3e} >= {tol}"


@pytest.fixture(scope="module")
def flight():
    """The recorded stream on both sides, and the JAX problem and carry
    configured from its frame 0 (configure reads only the settings that
    every case below shares)."""
    jr = jload()
    tr = tload(device="cpu")
    problem, carry = jr.configure(jadmm.ADMMSettings(**BENCH))
    return jr, tr, problem, carry


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------


def _port_linearized(cfg, d):
    f = lambda a: _t(np.asarray(a, np.float32))            # noqa: E731
    J = d["rel_jac_ang"].shape[2]
    snap = RobotSnapshot(
        w_R_b=f(d["w_R_b"]), base_pos=f(np.zeros(3)),
        base_ang_vel_world=f(d["base_ang_vel_world"]),
        com_pos=f(d["com_pos"]), total_mass=f(d["total_mass"]),
        momentum_body=f(d["momentum_body"]),
        inertia_locked=f(d["inertia_locked"]),
        amom_jets_body=f(_amom_body(d)),
        jet_axes_world=f(d["jet_axes_world"]),
        jet_arms_world=f(d["jet_arms_world"]),
        jac_jets_lin_joints=f(d["jac_jets_lin_joints"]),
        jac_com_joints=f(d["jac_com_joints"]),
        rel_jac_lin=f(d["rel_jac_lin"]), rel_jac_ang=f(d["rel_jac_ang"]),
        joint_pos=f(np.zeros(J)), jet_thrusts=f(d["jet_thrusts"]))
    g = lambda k: _t(np.asarray(d[k], np.float32), False)  # noqa: E731
    init = LambdaInit(rel_jac_lin=g("init_rel_jac_lin"),
                      rel_jac_ang=g("init_rel_jac_ang"),
                      jet_axes_world=g("init_jet_axes_world"),
                      jet_arms_world=g("init_jet_arms_world"),
                      rpy_init=g("rpy_init"))
    return tlinearize(
        cfg, snap, init, tuple(int(i) for i in d["joint_sel"]),
        alpha_gravity=f(d["alpha_gravity"]),
        pos_com_ref_now=f(d["pos_com_ref_now"]),
        est_thrust_dot=f(d["est_thrust_dot"]),
        thrust_des=f(d["thrust_des"]),
        thrust_dot_des=f(d["thrust_dot_des"]),
        throttle_cmd=f(d["throttle_cmd"]))


@pytest.mark.parametrize("k,d,ocfg,out", _cases(),
                         ids=lambda v: f"case{v}" if isinstance(v, int) else "")
def test_linearize_matches_golden_and_jax(k, d, ocfg, out):
    jcfg = _mpc_config(d, ocfg)
    lin = _port_linearized(_port_cfg(jcfg), d)
    live = _linearized(jcfg, d)
    for name in ("Ac", "BJ", "BT", "c"):
        got = getattr(lin, name)[0].numpy()
        # the float64 oracle, at the tolerance of test_golden_qp
        _close(got, out[name], 2e-5, f"{name} vs golden")
        # the live JAX call on the same float32 inputs
        _close(got, np.asarray(getattr(live, name)), 1e-6, f"{name} vs jax")


# ---------------------------------------------------------------------------
# condense, setup, solve on one QP of the stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def first_qp(flight):
    """Tick 0 of the stream on the JAX side: the prep, the QP, and the
    same prep and gradients carried across to the port."""
    jr, _, problem, carry = flight
    c1, prep = jmpc._tick_prep(jr.cfg, jr.sel, problem, carry, jr.snap_of(1),
                               jr.est_td[0])
    qp, q_diag, jrg, tig = jmpc.condense_from_prep(jr.cfg, jr.sched, jr.sel,
                                                   problem, c1, prep)
    return c1, prep, qp, (q_diag, jrg, tig)


def test_condense_matches_jax(flight, first_qp):
    jr, tr, problem, _ = flight
    c1, prep, qp, (q_diag, jrg, tig) = first_qp
    sel = np.asarray(jr.sel)
    lin = type(prep.lin)(*(_t(a) for a in prep.lin))
    tq = tcond.condense(
        tr.cfg, tr.sched, tcond.LinearizedDynamics(*lin), _t(prep.x0),
        _t(prep.state_ref), _t(q_diag, False), _t(problem.H_u, False),
        _t(jrg), _t(tig), _t(prep.pin), _t(c1.throttle_cmd),
        joint_pos_ctrl=_t(np.asarray(c1.joints_pos_ref)[sel]))
    # float32 products of the same inputs, summed in other orders
    for name in ("F", "f", "H", "q", "lb", "ub"):
        _close(getattr(tq, name)[0].numpy(), np.asarray(getattr(qp, name)),
               1e-5, name)


def _port_qp(qp):
    return tcond.CondensedQP(*(_t(a) for a in qp))


def test_setup_matches_jax(flight, first_qp):
    jr, tr, _, _ = flight
    qp = first_qp[2]
    settings = jadmm.ADMMSettings(**BENCH)
    js, jk, jrv, jrs = jcond.setup(jr.cfg, qp, settings)
    ts, tk, trv, trs = tcond.setup(tr.cfg, _port_qp(qp),
                                   tadmm.ADMMSettings(**BENCH))
    _close(ts.D[0].numpy(), np.asarray(js.D), 1e-6, "D")
    _close(ts.c[0].numpy(), np.asarray(js.c), 1e-6, "c")
    np.testing.assert_array_equal(trv[0].numpy(), np.asarray(jrv))
    np.testing.assert_array_equal(trs[0].numpy(), np.asarray(jrs))
    # an explicit inverse from a Cholesky of an equilibrated K in float32
    _close(tk[0].numpy(), np.asarray(jk), 1e-4, "kinv")


@pytest.mark.parametrize("mode", ["on", "off"])
def test_solve_matches_jax(flight, first_qp, mode):
    """One warm solve with the carried inverse: the kernel layout against
    the Pallas path, the box layout against the pure-JAX path."""
    jr, tr, problem, carry = flight
    c1, _, qp, _ = first_qp
    js = jadmm.ADMMSettings(**BENCH, pallas_mode=mode)
    ts = tadmm.ADMMSettings(**BENCH, kernel_mode=mode)
    kw = dict(warm_u=c1.warm_x, warm_y=c1.warm_y, kinv_prev=c1.kinv,
              rho_prev=c1.rho_vec, rho_scalar_prev=c1.rho_scalar)
    jsol = jax.jit(lambda qp, sc, kw: jcond.solve(
        jr.cfg, qp, js, scaling=sc, **kw))(qp, problem.cond_scaling, kw)
    sc = tcond.CondensedScaling(_t(problem.cond_scaling.D, False),
                                _t(problem.cond_scaling.c, False))
    launches = (kernels.admm_segment.launches, kernels.woodbury_ns.launches)
    tsol = tcond.solve(tr.cfg, _port_qp(qp), ts, scaling=sc,
                       **{k: _t(v) for k, v in kw.items()})
    # on the CPU the wrappers run their twins and count no launch
    assert launches == (kernels.admm_segment.launches,
                        kernels.woodbury_ns.launches)
    assert int(tsol.status[0]) == int(jsol.status)
    assert bool(tsol.guard_fired[0]) == bool(jsol.guard_fired)
    # a warm ADMM solve stopped at eps 1e-3 in float32: the iterate carries
    # rounding of ~40 mat-vecs and one Schur polish
    _close(tsol.u[0].numpy(), np.asarray(jsol.u), 1e-4, "u")
    _close(tsol.states[0].numpy(), np.asarray(jsol.states), 1e-4, "states")
    # the adaptive-ρ ratio divides two small residuals; relative
    np.testing.assert_allclose(tsol.rho_scalar[0].numpy(),
                               np.asarray(jsol.rho_scalar), rtol=1e-2)


# the sweep's recovery retry (parallel.monte_carlo.recovery_settings): a
# fresh factorisation, three adaptive-ρ marks, no early exit, here without
# the polish, as in tests/test_torch_sweep.py's crippled recovery case
RECOVERY = dict(kinv_reset=True, rho_update_iters=(25, 75, 150),
                term_check_every=0, polish=False, kinv_guard=True)


def test_solve_at_recovery_settings_matches_jax(flight, first_qp):
    """The retry's 200 iterations reach the pure-JAX solution on both
    layouts. On the way the adaptive ρ parts every pair of paths: its ratio
    at the first mark divides a primal residual at float32 rounding, so
    paths that sum in other orders take other ρ. After 40 iterations JAX's
    own Pallas and pure paths stand further apart than the port's from the
    pure path (printed: status, residuals, |Δu| against the pure path;
    on the CPU, Pallas in interpret mode closed SOLVED_INACCURATE at a
    primal residual of 1.6e-3 and the pure path SOLVED at 1.2e-6)."""
    jr, tr, problem, _ = flight
    c1, _, qp, _ = first_qp
    kw = dict(warm_u=c1.warm_x, warm_y=c1.warm_y, kinv_prev=c1.kinv,
              rho_prev=c1.rho_vec, rho_scalar_prev=c1.rho_scalar)
    sc = tcond.CondensedScaling(_t(problem.cond_scaling.D, False),
                                _t(problem.cond_scaling.c, False))
    for n in (40, 200):
        sols = {}
        for mode in ("off", "on"):
            js = jadmm.ADMMSettings(max_iter=n, pallas_mode=mode, **RECOVERY)
            sol = jax.jit(lambda qp, sc, kw: jcond.solve(
                jr.cfg, qp, js, scaling=sc, **kw))(qp, problem.cond_scaling,
                                                   kw)
            sols[f"jax-{mode}"] = (int(sol.status), float(sol.pri_res),
                                   float(sol.dua_res), np.asarray(sol.u))
            ts = tadmm.ADMMSettings(max_iter=n, kernel_mode=mode, **RECOVERY)
            sol = tcond.solve(tr.cfg, _port_qp(qp), ts, scaling=sc,
                              **{k: _t(v) for k, v in kw.items()})
            sols[f"port-{mode}"] = (int(sol.status[0]), float(sol.pri_res[0]),
                                    float(sol.dua_res[0]), sol.u[0].numpy())
        ref = sols["jax-off"][3]
        print(f"\n{n} iterations: " + "; ".join(
            f"{k} status {st} pri {p:.3e} dua {d:.3e} |du| "
            f"{np.abs(u - ref).max():.2e}"
            for k, (st, p, d, u) in sols.items()))
        for k, (st, p, d, u) in sols.items():
            assert np.isfinite(u).all() and np.isfinite([p, d]).all(), k
    for k in ("port-off", "port-on", "jax-on"):
        assert sols[k][0] == sols["jax-off"][0] == jadmm.SOLVED, k
        _close(sols[k][3], ref, 1e-5, f"u, {k}")


# ---------------------------------------------------------------------------
# configure
# ---------------------------------------------------------------------------


def test_configure_matches_jax(flight):
    _, tr, problem, carry = flight
    tp, tc = tr.configure(tadmm.ADMMSettings(**BENCH))
    jp, jc = _np(problem), _np(carry)
    for name in ("H", "H_u", "Q", "joint_pos_ref_ctrl", "com_pos_init",
                 "rpy_init", "traj_pos", "traj_vel", "traj_rpy",
                 "traj_rpydot", "alpha_traj"):
        _close(getattr(tp, name).numpy(), getattr(jp, name), 1e-7, name)
    for name in LambdaInit._fields:
        _close(getattr(tp.lambda_init, name).numpy(),
               getattr(jp.lambda_init, name), 1e-7, name)
    _close(tp.cond_scaling.D.numpy(), jp.cond_scaling.D, 1e-6, "D")
    _close(tp.cond_scaling.c.numpy(), jp.cond_scaling.c, 1e-6, "c")
    for name in ("n_turns", "throttle_counter", "ref_counter",
                 "pos_traj_idx", "alpha_traj_idx"):
        np.testing.assert_array_equal(getattr(tc, name)[0].numpy(),
                                      getattr(jc, name), err_msg=name)
    for name in ("rpy_old", "pos_com_ref", "lin_mom_ref", "rpy_ref",
                 "ang_mom_ref", "pos_com_ref_now", "rpy_ref_now",
                 "mom_ref_now", "alpha_gravity", "thrust_des",
                 "thrust_dot_des", "throttle_cmd", "joints_pos_ref",
                 "warm_x", "warm_y", "rho_vec", "rho_scalar"):
        _close(getattr(tc, name)[0].numpy(), getattr(jc, name), 1e-6, name)
    _close(tc.kinv[0].numpy(), jc.kinv, 1e-4, "kinv0")


def test_convert_carries_state_across_bit_for_bit(flight):
    """convert.py: the JAX snapshot, carry and problem arrive as the same
    float32 bits, with a lane dimension where the port batches, and
    to_numpy brings them back unchanged."""
    jr, tr, problem, carry = flight
    js = _np(jr.snap_of(5))
    ts = convert.snapshot_from_numpy(js, CPU)
    for name in RobotSnapshot._fields:
        a, b = getattr(js, name), getattr(ts, name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(b[0].numpy(), a, err_msg=name)
        np.testing.assert_array_equal(
            b[0].numpy(), getattr(tr.snap_of(5), name)[0].numpy())
    jc = _np(carry)
    back = convert.to_numpy(convert.carry_from_numpy(jc, CPU))
    for name in jc._fields:
        np.testing.assert_array_equal(getattr(back, name)[0],
                                      getattr(jc, name), err_msg=name)
    assert back.n_turns.dtype == np.int32
    tp = convert.problem_from_numpy(_np(problem), CPU)
    np.testing.assert_array_equal(tp.cond_scaling.D.numpy(),
                                  np.asarray(problem.cond_scaling.D))
    np.testing.assert_array_equal(tp.lambda_init.rel_jac_ang.numpy(),
                                  np.asarray(problem.lambda_init.rel_jac_ang))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

COUNTERS = ("n_turns", "throttle_counter", "ref_counter", "pos_traj_idx",
            "alpha_traj_idx")


@pytest.fixture(scope="module")
def joint_limits(flight):
    """The stream under the joint-position constraint: the box covers all
    120 inputs (n_box = 120 at box0 = 0), the wide shape of both kernels."""
    jr, tr, _, _ = flight
    over = dict(use_joint_position_constraint=True)
    jcfg = dataclasses.replace(jr.cfg, **over)
    tcfg = dataclasses.replace(tr.cfg, **over)
    jr = jr._replace(cfg=jcfg, sched=jschedule.build_schedule(jcfg))
    tr = tr._replace(cfg=tcfg, sched=tschedule.build_schedule(tcfg))
    problem, carry = jr.configure(jadmm.ADMMSettings(**BENCH))
    return jr, tr, problem, carry


def _run_both(flight, js, ts, batch, n_ticks, jitter=None):
    """Chain ``n_ticks`` replay ticks on both sides from the same carried
    state; yields (tick, jax output, jax carry, port output, port carry)."""
    jr, tr, problem, carry = flight
    tp = convert.problem_from_numpy(_np(problem), CPU)
    tc = expand_lanes(convert.carry_from_numpy(_np(carry), CPU), batch)

    def tick(c, s, e):
        return jmpc.mpc_tick(jr.cfg, jr.sched, jr.sel, js, problem, c, s, e)

    if batch == 1:
        step, jc = jax.jit(tick), carry
    else:
        step = jax.jit(jax.vmap(tick, axis_name=jadmm.BATCH_GUARD_AXIS))
        jc = jax.tree.map(lambda a: jnp.stack([a] * batch), carry)
    for t in range(n_ticks):
        snap, est = jr.snap_of(t + 1), jr.est_td[t]
        if batch > 1:
            snap = jax.tree.map(lambda a: jnp.stack([a] * batch), snap)
            snap = snap._replace(momentum_body=snap.momentum_body + jitter)
            est = jnp.stack([est] * batch)
        jc, jo = step(jc, snap, est)
        t_snap, t_est = tr.tick_inputs(
            t, batch, None if jitter is None else torch.as_tensor(jitter))
        tc, to = tmpc.mpc_tick(tr.cfg, tr.sched, tr.sel, ts, tp, tc, t_snap,
                               t_est)
        yield t, _np(jo), _np(jc), to, tc


def _check_tick(t, jo, jc, to, tc, batch, tol):
    lanes = lambda a: np.asarray(a).reshape(batch, -1)  # noqa: E731
    np.testing.assert_array_equal(to.status.numpy(), lanes(jo.status)[:, 0],
                                  err_msg=f"status, tick {t}")
    np.testing.assert_array_equal(to.guard_fired.numpy(),
                                  lanes(jo.guard_fired)[:, 0],
                                  err_msg=f"guard_fired, tick {t}")
    for name in COUNTERS:
        np.testing.assert_array_equal(
            getattr(tc, name).numpy().reshape(batch, -1),
            lanes(getattr(jc, name)), err_msg=f"{name}, tick {t}")
    _close(tc.rpy_old.numpy(), lanes(jc.rpy_old), 1e-6, f"rpy_old {t}")
    for name, atol in (("joints_pos_ref", tol["joints"]),
                       ("throttle", tol["throttle"]),
                       ("thrust_des", tol["thrust_des"])):
        np.testing.assert_allclose(
            getattr(to, name).numpy(), lanes(getattr(jo, name)), rtol=0,
            atol=atol, err_msg=f"{name}, tick {t}")
    _close(to.final_state.numpy(), lanes(jo.final_state),
           tol["final_state"], f"final_state, tick {t}")


def test_tick_batch1_kernel_layout_matches_jax(flight):
    """The real-time loop: one lane, per-lane decisions, the kernels' full
    padded layout against the Pallas kernels."""
    js = jadmm.ADMMSettings(**BENCH, pallas_mode="on")
    ts = tadmm.ADMMSettings(**BENCH, kernel_mode="on")
    # joints and throttle at the tolerances of test_pallas_solve's
    # pallas-vs-pure-JAX tick comparison; thrust_des is the predicted thrust
    # at knot 1 [N]; final_state is the horizon's last predicted state
    # (thrusts up to ~200 N), normalised by its largest entry
    tol = dict(joints=1e-4, throttle=1e-3, thrust_des=1e-3,
               final_state=2e-5)
    n = 0
    for t, jo, jc, to, tc in _run_both(flight, js, ts, 1, 2):
        _check_tick(t, jo, jc, to, tc, 1, tol)
        n += 1
    assert n == 2


def test_tick_batch4_bench_settings_matches_jax(flight):
    """The bench regime at batch 4 over the first 20 replay ticks: batch-wide
    decisions on the unpadded layout, lanes made distinct by momentum
    jitter as in bench.py:114-118 (drawn with numpy)."""
    batch = 4
    js = jadmm.ADMMSettings(**BENCH, pallas_mode="off",
                            guard_axis=jadmm.BATCH_GUARD_AXIS)
    ts = tadmm.ADMMSettings(**BENCH, kernel_mode="off", batch_guard=True)
    jitter = (0.1 * np.random.default_rng(0).standard_normal((batch, 6))
              ).astype(np.float32)
    # Looser than batch 1 for throttle and final_state, for a reason of the
    # reference itself: these ticks solve QPs whose adaptive-ρ ratio is
    # sensitive at float32 rounding, and JAX's own vmapped tick differs
    # from its unbatched tick on the same lanes and jitter (measured over
    # these 20 ticks: throttle by up to 4.1e-2 %, final_state by 4.5e-3 of
    # its largest entry on the cold tick 0 and under 1e-3 after it). The
    # port's batched tick follows the unbatched JAX tick to ~1e-5, so
    # against the vmapped one it inherits that spread: throttle to 0.1 %
    # (0.15 % of a 65 % command), final_state to 1e-2. Joints, thrust_des,
    # status, guard_fired and the counters stay as tight as at batch 1.
    tol = dict(joints=1e-4, throttle=0.1, thrust_des=1e-3, final_state=1e-2)
    n = 0
    for t, jo, jc, to, tc in _run_both(flight, js, ts, batch, 20, jitter):
        _check_tick(t, jo, jc, to, tc, batch, tol)
        n += 1
    assert n == 20


@pytest.mark.parametrize("mode", ["on", "off"])
def test_tick_joint_limits_matches_jax(joint_limits, mode):
    """The joint-limits configuration, one lane: the wide kernel layout
    (n_box = 120 at box0 = 0) against the Pallas kernels, and the box layout
    (a linear solve in place of Gauss–Jordan above 32 box rows) against the
    pure-JAX path."""
    js = jadmm.ADMMSettings(**BENCH, pallas_mode=mode)
    ts = tadmm.ADMMSettings(**BENCH, kernel_mode=mode)
    tol = dict(joints=1e-4, throttle=1e-3, thrust_des=1e-3,
               final_state=2e-5)
    n = 0
    for t, jo, jc, to, tc in _run_both(joint_limits, js, ts, 1, 2):
        _check_tick(t, jo, jc, to, tc, 1, tol)
        n += 1
    assert n == 2
