"""The slice as a whole: the port's closed loop against the JAX package.

One module-scoped fixture builds the flight loop of both packages
(calibrated Mk3 model from the URDF, LSTM+EKF jets, the flight solver
settings), settles 0.3 s and flies 20 ticks in JAX — one compile — on zero
trajectories (as tests/test_sim.py::test_closed_loop_smoke), then carries
the JAX problem and the configured ``LoopCarry`` across as numpy and flies
the same 20 ticks in the port on the CPU (the kernels' plain twins).

Tolerances over the 20 ticks: solver status equal tick by tick, CoM within
1e-4 m, throttle within 0.1 %, joints within 1e-4 rad. The two sides sum in
different orders and the JAX CPU path solves in the unpadded layout while
the port takes the padded layout of its kernels, so the comparison is at
float32 rounding amplified by the solver, not bitwise.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.runtime import flight as jflight
from ironcub_mpc_tpu.runtime import loop as jloop

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.qp import condensed as tcond
from ironcub_mpc_tpu_torch.runtime import flight as tflight
from ironcub_mpc_tpu_torch.runtime import loop as tloop
from ironcub_mpc_tpu_torch.runtime import trajectory as ttraj

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_TICKS = 20
SETTLE_S = 0.3
CHANNELS = {k: np.zeros((30, 3)) for k in
            ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
ALPHA = np.full(600, 0.08)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def flown():
    jl, jpos, jalpha = jflight.build_flight_loop()
    tl, tpos, talpha = tflight.build_flight_loop(device="cpu")
    q0_deg = jl.plant.sim_cfg.initial_position_deg

    js0 = jflight.standing_state(jl.plant, q0_deg)
    js = jax.jit(lambda s: jl.settle(s, SETTLE_S))(js0)
    jproblem, jcarry = jl.configure(js, CHANNELS, ALPHA)
    _, jtel = jl.rollout_jit()(jproblem, jcarry, N_TICKS)
    jtel = _np(jtel._replace(debug=None))

    # the port from the JAX state at handoff
    tproblem = convert.problem_from_numpy(_np(jproblem), "cpu")
    tcarry = convert.loop_carry_from_numpy(
        _np(jcarry._replace(plant=jcarry.plant._replace(rng=None))), "cpu")
    kernels.reset_launches()
    tcond.batch_any.syncs = 0
    _, ttel = tl.rollout(tproblem, tcarry, N_TICKS)
    return SimpleNamespace(jl=jl, tl=tl, js0=js0, js=js, jproblem=jproblem,
                           jcarry=jcarry, jtel=jtel, ttel=ttel, jpos=jpos,
                           tpos=tpos, jalpha=jalpha, talpha=talpha,
                           syncs=tcond.batch_any.syncs)


def test_loops_are_configured_alike(flown):
    jl, tl = flown.jl, flown.tl
    assert tl.n_substeps == jl.n_substeps == 5
    assert tl.alpha_lp == jl.alpha_lp
    assert tl.sel == jl.sel
    renamed = {"pallas_mode": "kernel_mode", "guard_axis": "batch_guard"}
    for f in jadmm.ADMMSettings.__dataclass_fields__:
        if f not in renamed:
            assert getattr(tl.settings, f) == getattr(jl.settings, f), f
    assert tl.settings.max_iter == 120
    assert tl.settings.rho_update_iters == (20, 50)
    assert tl.settings.term_check_every == 5
    assert tl.settings.eps_abs == tl.settings.eps_rel == 1e-4
    assert tl.settings.batch_guard is False
    assert tl.plant.params.kd == jl.plant.params.kd == 60.0
    assert tl.cfg.weight_regularization_joint_pos == 200.0
    default = tloop.ClosedLoop(tl.plant)
    assert default.settings == tadmm.ADMMSettings(max_iter=150)
    assert jloop.ClosedLoop(jl.plant).settings.max_iter == 150


def test_trajectories_match(flown):
    for jt, tt in ((flown.jpos, flown.tpos), (flown.jalpha, flown.talpha)):
        assert tt.fps == jt.fps and tt.length == jt.length
        assert sorted(tt.channels) == sorted(jt.channels)
        for k, v in tt.channels.items():
            np.testing.assert_allclose(v, np.asarray(jt.channels[k]),
                                       rtol=1e-6, atol=1e-7)
    raw = np.linspace(0.0, 1.0, 7)[:, None] * np.array([[1.0, -2.0]])
    from ironcub_mpc_tpu.runtime import trajectory as jtraj
    np.testing.assert_array_equal(ttraj.upsample(raw, 10, 50),
                                  jtraj.upsample(raw, 10, 50))
    t = ttraj.Trajectory({"a": raw}, 10)
    assert t.advance(6) == 6 and t.advance(2) == 3
    np.testing.assert_array_equal(t.value("a", 99), raw[-1])


def test_status_equal_tick_by_tick(flown):
    got = flown.ttel.solver_status[:, 0].numpy()
    np.testing.assert_array_equal(got, flown.jtel.solver_status)
    assert np.isin(got, (tadmm.SOLVED, tadmm.SOLVED_INACCURATE)).all()
    np.testing.assert_array_equal(flown.ttel.guard_fired[:, 0].numpy(),
                                  flown.jtel.guard_fired)
    np.testing.assert_array_equal(flown.ttel.on_ground[:, 0].numpy(),
                                  flown.jtel.on_ground)
    # per-lane decisions: nothing was read back on the host, and with no
    # card the twins ran (no launch was counted)
    assert flown.syncs == 0
    assert kernels.admm_segment.launches == 0
    assert kernels.woodbury_ns.launches == 0


@pytest.mark.parametrize("field,tol", [
    ("com_position", 1e-4), ("throttle", 0.1), ("joints_pos_meas", 1e-4),
    ("joints_pos_ref", 1e-4), ("base_position", 1e-4),
    ("base_orientation", 1e-4), ("com_position_desired", 1e-6),
    ("base_orientation_desired", 1e-6)])
def test_flown_channels_match(flown, field, tol):
    got = getattr(flown.ttel, field)[:, 0].numpy()
    want = getattr(flown.jtel, field)
    assert got.shape == want.shape == (N_TICKS,) + want.shape[1:]
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{field}: max abs err {err:.3e} > {tol}"


def test_remaining_channels_match_loosely(flown):
    """Every other channel, relative to its largest magnitude: 2e-3 (the
    momenta and thrust rates amplify the 1e-4 state differences)."""
    assert flown.ttel._fields == jloop.TickTelemetry._fields
    for name in flown.ttel._fields:
        got, want = getattr(flown.ttel, name), getattr(flown.jtel, name)
        if name == "debug":
            assert got is None
            continue
        got = got[:, 0].numpy()
        assert got.shape == want.shape, name
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        if name in ("pri_res", "dua_res"):
            continue                       # residuals at the 1e-4 stop level
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max()) / scale
        assert err < 2e-3, f"{name}: {err:.3e}"


def test_settle_and_configure_match_from_the_same_standing_state(flown):
    """The port's own settle and configure (not the converted carry): 300
    substeps from the standing state stay within 1e-4 of JAX's (absolute
    for the pose and velocities, relative for the thrusts and 1e-3 relative
    for the EKF's thrust rates), and
    ``configure`` on the converted settled state gives the JAX problem and
    carry (2e-5 relative, the tolerance of tests/test_torch_tick.py)."""
    tl = flown.tl
    ts0 = convert.plant_state_from_numpy(
        _np(flown.js0._replace(rng=None)), "cpu")
    ts = tl.settle(ts0, SETTLE_S)
    js = _np(flown.js._replace(rng=None))
    for name in ("base_R", "base_p", "base_v", "q", "qd"):
        np.testing.assert_allclose(getattr(ts, name)[0].numpy(),
                                   getattr(js, name), rtol=0, atol=1e-4,
                                   err_msg=name)
    # thrusts are ~12 N after 300 integrated LSTM steps: relative 1e-4
    np.testing.assert_allclose(ts.thrust_nn[0].numpy(), js.thrust_nn,
                               rtol=1e-4)
    np.testing.assert_allclose(ts.ekf.x[0].numpy(), js.ekf.x, rtol=1e-3)

    ts = convert.plant_state_from_numpy(js, "cpu")
    problem, carry = tl.configure(ts, CHANNELS, ALPHA)
    jp = _np(flown.jproblem)
    for name in ("H_u", "Q", "joint_pos_ref_ctrl", "com_pos_init", "rpy_init",
                 "traj_pos", "alpha_traj"):
        got, want = getattr(problem, name).numpy(), getattr(jp, name)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
        assert err < 2e-5, (name, err)
    jc = _np(flown.jcarry.mpc)
    for name in ("pos_com_ref", "rpy_ref", "thrust_des", "throttle_cmd",
                 "joints_pos_ref", "kinv", "rho_vec"):
        got, want = getattr(carry.mpc, name)[0].numpy(), getattr(jc, name)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
        assert err < 2e-4, (name, err)
    assert int(carry.mpc.throttle_counter[0]) == int(jc.throttle_counter)


def test_batched_lanes_fly_like_single_lanes(flown):
    """Three lanes from the same handoff, lane 1 with a wind gust: lane 0 of
    the batch flies as the single lane did, and the gust moves lane 1."""
    tl = flown.tl
    tproblem = convert.problem_from_numpy(_np(flown.jproblem), "cpu")
    c1 = convert.loop_carry_from_numpy(
        _np(flown.jcarry._replace(
            plant=flown.jcarry.plant._replace(rng=None))), "cpu")

    def lanes(x):
        if isinstance(x, tuple):
            return type(x)(*(lanes(v) for v in x))
        return None if x is None else x.expand(3, *x.shape[1:]).clone()

    c3 = lanes(c1)
    wind = torch.zeros(3, 3)
    wind[1] = torch.tensor([30.0, -20.0, 0.0])
    c3 = c3._replace(plant=c3.plant._replace(wind_force=wind))
    _, tel = tl.rollout(tproblem, c3, 6)
    assert tel.com_position.shape == (6, 3, 3)
    assert tel.solver_status.shape == (6, 3)
    np.testing.assert_allclose(tel.com_position[:, 0].numpy(),
                               flown.ttel.com_position[:6, 0].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tel.com_position[:, 2].numpy(),
                               tel.com_position[:, 0].numpy(), rtol=0,
                               atol=1e-6)
    assert float((tel.base_lin_vel[-1, 1] - tel.base_lin_vel[-1, 0]).abs()
                 .max()) > 1e-4


def test_tick_settings_override_and_rollout_length(flown):
    tl = flown.tl
    tproblem = convert.problem_from_numpy(_np(flown.jproblem), "cpu")
    c = convert.loop_carry_from_numpy(
        _np(flown.jcarry._replace(
            plant=flown.jcarry.plant._replace(rng=None))), "cpu")
    boosted = dataclasses.replace(tl.settings, kinv_reset=True, max_iter=200,
                                  term_check_every=0)
    c2, tel = tl.tick(tproblem, c, settings=boosted)
    assert int(tel.solver_status[0]) in (tadmm.SOLVED,
                                         tadmm.SOLVED_INACCURATE)
    np.testing.assert_allclose(tel.throttle.numpy(),
                               flown.ttel.throttle[0].numpy(), atol=0.1)
    assert isinstance(c2, tloop.LoopCarry)
    with pytest.raises(ValueError):
        tl.rollout(tproblem, c, 0)


def test_flight_stats_equal_on_fixed_telemetry():
    """The copied ``flight_stats`` on a numpy-seeded telemetry record."""
    rng = np.random.default_rng(8)
    n = 300
    ramp = np.linspace(0.0, 1.0, n)[:, None]
    tel = SimpleNamespace(
        com_position=rng.normal(0, 0.02, (n, 3)) + [0, 0, 0.6],
        com_position_desired=np.tile([0.0, 0.0, 0.6], (n, 1)),
        base_orientation=rng.normal(0, 0.01, (n, 3)) + [0, 0, 3.13],
        base_orientation_desired=np.tile([0.0, 0.0, -3.13], (n, 1)),
        solver_status=rng.choice([1, 1, 1, 2, 5], n),
        estimated_thrust=200.0 * ramp * np.ones((n, 4)))
    for mass in (None, 70.0):
        assert tflight.flight_stats(tel, 0.005, total_mass=mass) == \
            jflight.flight_stats(tel, 0.005, total_mass=mass)
    assert "takeoff_t_s" in tflight.flight_stats(tel, 0.005, total_mass=70.0)


def test_run_flight_short_slice_on_cpu(flown):
    """The flight entry point end to end on the CPU: 0.2 s settle, 10
    mission ticks, two lanes."""
    tel, info = tflight.run_flight(0.05, settle_s=0.2, loop=flown.tl,
                                   pos_traj=flown.tpos,
                                   alpha_traj=flown.talpha, batch=2)
    assert info["n_ticks"] == 10 and info["batch"] == 2
    assert info["device"] == "cpu" and info["jets"] == "lstm+ekf"
    assert tel.com_position.shape == (10, 2, 3)
    stats = tflight.flight_stats(
        type(tel)(*(None if v is None else v[:, 0].numpy() for v in tel)),
        flown.tl.cfg.period_mpc, total_mass=flown.tl.kd.model.total_mass)
    assert stats["finite"] and stats["n_not_solved"] == 0
    assert stats["com_max_m"] < 0.05
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tflight.build_flight_loop()
