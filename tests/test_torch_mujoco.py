"""The port's host-MuJoCo plant and cross-engine validation against the JAX
package, and the port's kinodynamics against MuJoCo itself.

- ``HostMujocoSim``: the port's and JAX's on the same MuJoCo state give the
  same snapshot (rtol 1e-5, atol 1e-6 × the field's largest magnitude, as
  tests/test_torch_dynamics.py) where JAX's float32 snapshot holds it
  against float64, the port against float64 elsewhere; the LSTM+EKF chain
  under tests/test_plant_divergence.py's throttle schedule within 1e-3 N of
  the port's own plant and of float64, and of JAX's beyond JAX's own
  float32 drift; 6 closed-loop ticks as
  tests/test_aux_subsystems.py's, against JAX's at the batch-1 tick
  tolerances (statuses equal, joints 1e-4 rad, throttle 1e-3 %,
  thrust_des 1e-3 N); the headless viewer.
- The port's ``KinDyn`` against tests/mjcf_oracle.py (an independent
  rigid-body implementation) at tests/test_kinodynamics.py's tolerances.
- ``compare_plants`` at 20 ticks finite and solved; at 300 ticks (slow)
  within tests/test_plant_divergence.py's bounds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ironcub_mpc_tpu.core.config import (MPCConfig as JMPCConfig,  # noqa: E402
                                         RobotConfig as JRobotConfig,
                                         SimConfig as JSimConfig,
                                         joint_selector as jjoint_selector)
from ironcub_mpc_tpu.dynamics import KinDyn as JKinDyn  # noqa: E402
from ironcub_mpc_tpu.dynamics import build_ironcub_model as jbuild  # noqa: E402
from ironcub_mpc_tpu.horizon import build_schedule as jbuild_schedule  # noqa: E402
from ironcub_mpc_tpu.ops import admm as jadmm  # noqa: E402
from ironcub_mpc_tpu.qp import mpc as jmpc  # noqa: E402
from ironcub_mpc_tpu.sim.jet_lstm import LSTMJetModel as JLSTM  # noqa: E402
from ironcub_mpc_tpu.sim.mujoco_sim import HostMujocoSim as JSim  # noqa: E402

from ironcub_mpc_tpu_torch.core.config import (MPCConfig, RobotConfig,  # noqa: E402
                                               SimConfig, joint_selector)
from ironcub_mpc_tpu_torch.dynamics import (KinDyn,  # noqa: E402
                                            build_ironcub_model,
                                            compute_snapshot)
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule  # noqa: E402
from ironcub_mpc_tpu_torch.ops import admm  # noqa: E402
from ironcub_mpc_tpu_torch.ops.so3 import rpy_to_matrix  # noqa: E402
from ironcub_mpc_tpu_torch.qp import mpc  # noqa: E402
from ironcub_mpc_tpu_torch.sim.ekf import JetEKF  # noqa: E402
from ironcub_mpc_tpu_torch.sim.jet_lstm import LSTMJetModel  # noqa: E402
from ironcub_mpc_tpu_torch.sim.mujoco_sim import HostMujocoSim  # noqa: E402
from ironcub_mpc_tpu_torch.sim.plant import Plant  # noqa: E402
from ironcub_mpc_tpu_torch.sim.validate import compare_plants  # noqa: E402

import mjcf_oracle  # noqa: E402
from test_torch_tick import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = str(ROOT / "data/jet_lstm_weights.npz")
MODEL = build_ironcub_model()
KD = KinDyn(MODEL, device="cpu")
JKD = JKinDyn(jbuild())
Q_STAND = np.radians(SimConfig().initial_position_deg)


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    """rtol with atol scaled by the field's largest magnitude (at least 1),
    as tests/test_torch_dynamics.py."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64).reshape(got.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _sole_z():
    ls = KD.fk(torch.eye(3)[None], torch.zeros((1, 3)),
               torch.as_tensor(Q_STAND, dtype=torch.float32)[None])
    _, p_f = KD.frame_poses(ls, KD.frames(("l_sole",)))
    return float(p_f[0, 0, 2])


def _pair(use_nn=False):
    """The port's and JAX's HostMujocoSim on the same configuration."""
    t = HostMujocoSim(KD, RobotConfig(), SimConfig(use_nn_jet_dynamics=use_nn),
                      lstm=LSTMJetModel(WEIGHTS, device="cpu") if use_nn
                      else None)
    j = JSim(JKD, JRobotConfig(), JSimConfig(use_nn_jet_dynamics=use_nn),
             lstm=JLSTM(WEIGHTS) if use_nn else None)
    return t, j


def _both(sims, fn):
    for s in sims:
        fn(s)


# ---------------------------------------------------------------------------
# HostMujocoSim against JAX's
# ---------------------------------------------------------------------------


def _snapshot_fields(snap):
    return {k: v for k, v in snap._asdict().items() if v is not None}


def _float64_snapshot(sim):
    """The snapshot of ``sim``'s state through the port's kinodynamics in
    float64: the truth both float32 snapshots are measured against."""
    from scipy.spatial.transform import Rotation

    kd64 = KinDyn(MODEL, dtype=torch.float64, device="cpu")
    quat = sim.data.qpos[3:7]
    R = Rotation.from_quat(quat[[1, 2, 3, 0]]).as_matrix()
    v = np.concatenate([sim.get_base_velocity(),
                        sim.get_base_angular_velocity()])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None]  # noqa: E731
    return compute_snapshot(
        kd64, RobotConfig().jets_list, f(R), f(sim.data.qpos[0:3]), f(v),
        f(sim.get_joint_positions()), f(sim.get_joint_velocities()),
        f(sim.get_estimated_thrust()))


def test_snapshot_matches_jax_on_the_standing_state():
    """The state of tests/test_aux_subsystems.py's snapshot test (standing
    after a 0.5 s settle under PD): the port's snapshot against JAX's, field
    by field, and the port's CoM against MuJoCo's own."""
    sims = _pair()
    z = -_sole_z() + 0.012
    _both(sims, lambda s: s.set_state(np.eye(3), [0, 0, z], Q_STAND))
    _both(sims, lambda s: s.set_joint_positions(Q_STAND))
    _both(sims, lambda s: s.set_thrust(np.full(4, 10.0)))
    _both(sims, lambda s: s.step(500))
    t, j = sims
    np.testing.assert_array_equal(t.data.qpos, j.data.qpos)
    assert abs(t.get_base_position()[2] - z + 0.012) < 0.05   # standing
    got, want = t.snapshot(), j.snapshot()
    assert got.zmp is None and want.zmp is None
    for name, g in _snapshot_fields(got).items():
        assert g.shape[0] == 1, name                 # one lane
        _close(g[0].numpy(), np.asarray(getattr(want, name)),
               f"snapshot.{name}")
    mujoco.mj_forward(t.model, t.data)
    np.testing.assert_allclose(got.com_pos[0].numpy(), t.data.subtree_com[1],
                               atol=1e-4)


def test_snapshot_on_a_moving_state_matches_float64():
    """A tumbling state (dropped from 0.3 m, uneven thrust, base rates up
    to 1.35 rad/s): each engine's float32 snapshot against the float64
    snapshot of the same MuJoCo state. The port holds the tolerance of
    tests/test_torch_dynamics.py against it and is nowhere farther from it
    than JAX's (whose jitted momentum is 4.0e-5 off at a scale of 2.88
    here, the port's 1.3e-6)."""
    sims = _pair()
    rng = np.random.default_rng(11)
    R = rpy_to_matrix(torch.tensor([0.05, -0.08, 0.3])).numpy()
    q = Q_STAND + rng.normal(0, 0.1, MODEL.n_joints)
    _both(sims, lambda s: s.set_state(R, [0.1, -0.2, -_sole_z() + 0.3], q))
    _both(sims, lambda s: s.set_joint_positions(Q_STAND))
    _both(sims, lambda s: s.set_thrust(np.array([180.0, 170.0, 160.0, 150.0])))
    _both(sims, lambda s: s.step(40))
    t, j = sims
    np.testing.assert_array_equal(t.data.qvel, j.data.qvel)
    assert np.abs(t.data.qvel).max() > 1.0          # a moving state
    got, want = t.snapshot(), j.snapshot()
    truth = _float64_snapshot(t)
    for name, g in _snapshot_fields(got).items():
        ref = getattr(truth, name)[0].numpy()
        _close(g[0].numpy(), ref, f"snapshot.{name} vs float64")
        scale = max(float(np.abs(ref).max()), 1.0)
        err_port = np.abs(g[0].numpy() - ref).max()
        err_jax = np.abs(np.asarray(getattr(want, name)) - ref).max()
        assert err_port <= err_jax + 1e-6 * scale, (name, err_port, err_jax)


def test_jet_chain_matches_the_plant_float64_and_jax_open_loop():
    """The LSTM+EKF chain under tests/test_plant_divergence.py's throttle
    schedule after every segment: the port's MuJoCo sim within 1e-3 N of
    the port's own plant (the same chain in both engines) and of the chain
    run in float64. JAX's float32 chain drifts from the float64 one (1.06e-3
    N after the 6th segment, the port's 6.4e-5), so the port is held to
    JAX's within 1e-3 N plus JAX's own distance from float64."""
    t, j = _pair(use_nn=True)
    sim_cfg = SimConfig(use_nn_jet_dynamics=True)
    plant = Plant(KD, RobotConfig(), sim_cfg,
                  lstm=LSTMJetModel(WEIGHTS, device="cpu"))
    lstm64 = LSTMJetModel(WEIGHTS, dtype=torch.float64, device="cpu")
    ekf64 = JetEKF(sim_cfg.timestep, dtype=torch.float64, device="cpu")
    t64 = torch.full((4,), 10.0, dtype=torch.float64)
    e64 = ekf64.init(t64)
    q0 = np.zeros(23)
    s = plant.init_state(np.eye(3), np.array([0.0, 0.0, 1.0]), q0)
    _both((t, j), lambda m: m.set_state(np.eye(3), [0.0, 0.0, 1.0], q0))
    rng = np.random.default_rng(7)
    for seg in range(6):
        u = rng.uniform(20.0, 60.0, 4).astype(np.float32)
        s = plant.set_throttle(s, torch.as_tensor(u)[None])
        _both((t, j), lambda m: m.set_throttle(u))
        s = plant.step(s, 50)
        _both((t, j), lambda m: m.step(50))
        u64 = torch.as_tensor(u, dtype=torch.float64)
        for _ in range(50):
            t64, td64 = lstm64.step(t64, u64, sim_cfg.timestep)
            e64 = ekf64.update(e64, u64, t64, td64)
        truth = e64.x[:, 0].numpy()
        got = t.get_estimated_thrust()
        want = np.asarray(j.get_estimated_thrust())
        np.testing.assert_allclose(got, plant.applied_thrust(s)[0].numpy(),
                                   rtol=0, atol=1e-3, err_msg=f"seg {seg}")
        np.testing.assert_allclose(got, truth, rtol=0, atol=1e-3,
                                   err_msg=f"seg {seg}")
        jax_drift = np.abs(want - truth).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 + jax_drift,
                                   err_msg=f"seg {seg}")
        np.testing.assert_array_equal(t.estimated_thrust_dot()[0].numpy(),
                                      t.get_estimated_thrust_dot())


def test_closed_loop_ticks_match_jax():
    """6 MPC ticks against each engine's MuJoCo plant (the scenario of
    tests/test_aux_subsystems.py::test_host_mujoco_closed_loop_ticks),
    each side configured from its own snapshot of the same state."""
    sims = _pair()
    z = -_sole_z() + 0.012
    _both(sims, lambda s: s.set_state(np.eye(3), [0, 0, z], Q_STAND))
    _both(sims, lambda s: s.set_joint_positions(Q_STAND))
    _both(sims, lambda s: s.set_thrust(np.full(4, 10.0)))
    _both(sims, lambda s: s.step(400))
    t, j = sims
    channels = {k: np.zeros((30, 3)) for k in
                ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
    alpha = np.full(600, 0.08)

    jcfg = JMPCConfig()
    jsched, jsel = jbuild_schedule(jcfg), jjoint_selector(JRobotConfig(), jcfg)
    jset = jadmm.ADMMSettings(max_iter=60)
    jprob, jcarry = jmpc.configure(jcfg, jsched, jsel, j.snapshot(), channels,
                                   alpha, jset)
    jtick = jax.jit(lambda p, c, s, e: jmpc.mpc_tick(
        jcfg, jsched, jsel, jset, p, c, s, e))

    cfg = MPCConfig()
    sched, sel = build_schedule(cfg), joint_selector(RobotConfig(), cfg)
    settings = admm.ADMMSettings(max_iter=60)
    prob, carry = mpc.configure(cfg, sched, sel, t.snapshot(), channels,
                                alpha, settings, device="cpu")
    for k in range(6):
        jcarry, jout = jtick(jprob, jcarry, j.snapshot(),
                             jnp.asarray(j.get_estimated_thrust_dot(),
                                         jnp.float32))
        carry, out = mpc.mpc_tick(cfg, sched, sel, settings, prob, carry,
                                  t.snapshot(), t.estimated_thrust_dot())
        assert int(out.status[0]) == int(jout.status), k
        assert int(out.status[0]) in (admm.SOLVED, admm.SOLVED_INACCURATE)
        for name, tol in (("joints_pos_ref", 1e-4), ("throttle", 1e-3),
                          ("thrust_des", 1e-3)):
            np.testing.assert_allclose(
                getattr(out, name)[0].numpy(), np.asarray(getattr(jout, name)),
                rtol=0, atol=tol, err_msg=f"tick {k} {name}")
        for s, o in ((t, out), (j, jout)):
            s.set_thrust(np.asarray(o.thrust_des).reshape(4))
            s.set_joint_positions(np.asarray(o.joints_pos_ref).reshape(23))
            s.set_throttle(np.asarray(o.throttle).reshape(4))
            s.step(5)


def test_viewer_headless_fallback(monkeypatch):
    """run_visualization on a headless host degrades gracefully and
    is_running() keeps the driver loop alive."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.warns(UserWarning, match="viewer unavailable"):
        sim = HostMujocoSim(KD, RobotConfig(),
                            SimConfig(use_nn_jet_dynamics=False),
                            run_visualization=True)
    assert sim.viewer is None
    assert sim.is_running()
    sim.set_state(np.eye(3), np.array([0.0, 0.0, 1.0]), Q_STAND)
    sim.step(3)  # viewer_sync no-ops headless
    assert sim.is_running()


# ---------------------------------------------------------------------------
# the port's kinodynamics against MuJoCo (tests/mjcf_oracle.py)
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(7)
Q0 = RNG.normal(0, 0.3, MODEL.n_joints)
QD0 = RNG.normal(0, 0.4, MODEL.n_joints)
BASE_R = rpy_to_matrix(torch.tensor([0.1, -0.2, 0.3],
                                    dtype=torch.float64)).numpy()
BASE_P = np.array([0.3, -0.1, 0.8])
BASE_V = np.array([0.2, -0.1, 0.4, 0.3, -0.2, 0.1])


@pytest.fixture(scope="module")
def oracle():
    mj, data = mjcf_oracle.make_oracle(MODEL)
    mjcf_oracle.set_state(mj, data, MODEL, BASE_R, BASE_P, Q0, BASE_V, QD0)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)[None]  # noqa: E731
    ls = KD.fk(f(BASE_R), f(BASE_P), f(Q0))
    J = KD.link_spatial_jacobians(ls, f(BASE_P))
    I_sp, c_w, _ = KD.link_spatial_inertias(ls)
    nu = f(np.concatenate([BASE_V, QD0]))
    return dict(mj=mj, data=data, ls=ls, J=J, I_sp=I_sp, c_w=c_w, nu=nu,
                perm=mjcf_oracle.dof_permutation(mj, MODEL), f=f)


def _fk(o):
    mj, data, ls = o["mj"], o["data"], o["ls"]
    for i, name in enumerate(MODEL.link_names):
        bid = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_BODY, name)
        np.testing.assert_allclose(ls.p[0, i].numpy(), data.xpos[bid],
                                   atol=1e-5)
        np.testing.assert_allclose(ls.R[0, i].numpy(),
                                   data.xmat[bid].reshape(3, 3), atol=1e-5)


def _com(o):
    np.testing.assert_allclose(KD.com(o["c_w"])[0].numpy(),
                               o["data"].subtree_com[1], atol=1e-5)
    assert abs(MODEL.total_mass - mujoco.mj_getTotalmass(o["mj"])) < 1e-6


def _mass_matrix(o):
    mj, data, perm = o["mj"], o["data"], o["perm"]
    M = KD.mass_matrix(o["J"], o["I_sp"])[0].numpy().astype(np.float64)
    full = np.zeros((mj.nv, mj.nv))
    mujoco.mj_fullM(mj, data, full)
    np.testing.assert_allclose(M[6:, 6:], full[np.ix_(perm, perm)],
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(M, M.T, atol=1e-4)
    np.testing.assert_allclose(M[:3, :3], MODEL.total_mass * np.eye(3),
                               atol=1e-4, rtol=1e-5)


def _site_jacobians(o):
    mj, data, perm, ls, J = o["mj"], o["data"], o["perm"], o["ls"], o["J"]
    names = ("l_arm_jet_turbine", "chest_r_jet_turbine", "l_sole")
    fs = KD.frames(names)
    _, p_f = KD.frame_poses(ls, fs)
    Jf = KD.frame_jacobian(J, ls, fs.link, p_f)[0].numpy()
    for k, name in enumerate(names):
        sid = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_SITE, name)
        jacp, jacr = np.zeros((3, mj.nv)), np.zeros((3, mj.nv))
        mujoco.mj_jacSite(mj, data, jacp, jacr, sid)
        np.testing.assert_allclose(Jf[k, 0:3, 6:], jacp[:, perm], atol=1e-5)
        np.testing.assert_allclose(Jf[k, 3:6, 6:], jacr[:, perm], atol=1e-5)
        np.testing.assert_allclose(p_f[0, k].numpy(), data.site_xpos[sid],
                                   atol=1e-5)


def _momentum(o):
    mj, data = o["mj"], o["data"]
    A_O = KD.momentum_matrix_origin(o["J"], o["I_sp"])
    A_G = KD.centroidal_momentum_matrix(A_O, KD.com(o["c_w"]))
    h = (A_G[0] @ o["nu"][0]).numpy().astype(np.float64)
    mujoco.mj_subtreeVel(mj, data)
    np.testing.assert_allclose(
        h[:3], mujoco.mj_getTotalmass(mj) * data.subtree_linvel[1], atol=2e-4)
    np.testing.assert_allclose(h[3:], data.subtree_angmom[1], atol=2e-4)


def _bias(o):
    bias = KD.bias_forces(o["J"], o["I_sp"], o["ls"], o["f"](BASE_P),
                          o["nu"], torch.tensor([0.0, 0.0, -9.81]))
    np.testing.assert_allclose(bias[0, 6:].numpy().astype(np.float64),
                               o["data"].qfrc_bias[o["perm"]], atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("check", [_fk, _com, _mass_matrix, _site_jacobians,
                                   _momentum, _bias],
                         ids=["fk", "com", "mass_matrix", "site_jacobians",
                              "momentum", "bias_forces"])
def test_kinodynamics_matches_mujoco(oracle, check):
    check(oracle)


# ---------------------------------------------------------------------------
# cross-engine validation
# ---------------------------------------------------------------------------


def test_compare_plants_short_run_is_finite_and_solved():
    r = compare_plants(n_ticks=20, device="cpu")
    assert r["finite"] and r["n_ticks"] == 20 and r["jets"] == "lstm+ekf"
    assert r["torch_solved_frac"] == 1.0 and r["mujoco_solved_frac"] == 1.0
    assert "jax_solved_frac" not in r
    assert r["com_div_max_m"] < 0.06 and r["rpy_div_max_deg"] < 8.0


@pytest.mark.slow
def test_compare_plants_300_ticks_within_the_divergence_bounds():
    """tests/test_plant_divergence.py's bounds on the port's plant."""
    r = compare_plants(n_ticks=300, settle_s=1.0, use_nn=True,
                       alpha_ramp=True, device="cpu")
    assert r["finite"], r
    assert r["torch_solved_frac"] == 1.0 and r["mujoco_solved_frac"] == 1.0, r
    assert r["com_div_max_m"] < 0.06, r
    assert r["rpy_div_max_deg"] < 8.0, r
    assert r["base_div_max_m"] < 0.09, r
    assert r["thrust_div_max_n"] < 1.5, r
