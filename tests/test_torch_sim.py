"""The port's simulation layer against the JAX package: the LSTM jet model,
the per-jet EKF, the discrete jet step with its closed-form Jacobians, and
the rigid-body plant (substeps, sole wrenches, sensors).

Inputs come from numpy seeds; a JAX ``PlantState`` crosses over as numpy
through ``ironcub_mpc_tpu_torch.convert`` so both plants step from the same
state. Sensor noise cannot match JAX's stream bit for bit, so every
comparison runs with noise off and the noisy sensor is tested for its
statistics.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.core.config import RobotConfig, SimConfig
from ironcub_mpc_tpu import dynamics as jdyn
from ironcub_mpc_tpu.ops import jet_model as jjm
from ironcub_mpc_tpu.runtime import flight as jflight
from ironcub_mpc_tpu.sim.ekf import JetEKF as JJetEKF
from ironcub_mpc_tpu.sim.jet_lstm import LSTMJetModel as JLSTM
from ironcub_mpc_tpu.sim.plant import Plant as JPlant
from ironcub_mpc_tpu.sim.plant import PlantParams as JPlantParams

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch import dynamics as tdyn
from ironcub_mpc_tpu_torch.core import config as tconfig
from ironcub_mpc_tpu_torch.ops import jet_model as tjm
from ironcub_mpc_tpu_torch.runtime import flight as tflight
from ironcub_mpc_tpu_torch.sim.ekf import JetEKF as TJetEKF
from ironcub_mpc_tpu_torch.sim.jet_lstm import LSTMJetModel as TLSTM
from ironcub_mpc_tpu_torch.sim.plant import Plant as TPlant
from ironcub_mpc_tpu_torch.sim.plant import PlantParams as TPlantParams
from ironcub_mpc_tpu_torch.sim.plant import PlantState as TPlantState

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = str(ROOT / "data/jet_lstm_weights.npz")
DT = 0.001


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# jet model: discrete step and its Jacobians
# ---------------------------------------------------------------------------


def _jet_points(seed=0, n=12):
    rng = np.random.default_rng(seed)
    return (rng.uniform(5, 220, n).astype(np.float32),
            rng.uniform(-60, 60, n).astype(np.float32),
            rng.uniform(0, 100, n).astype(np.float32))


def test_jet_step_matches_jax():
    T, Td, u = _jet_points()
    got = tjm.step(_t(T), _t(Td), _t(u), DT)
    ref = jjm.step(jnp.asarray(T), jnp.asarray(Td), jnp.asarray(u), DT)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-5)


def test_step_jacobians_closed_form_matches_jacfwd_and_jax():
    """The closed-form 2×2 A and 2×1 B against ``torch.func.jacfwd`` of the
    port's own step (float64, 1e-10) and against the JAX package's
    ``jax.jacfwd`` Jacobians (float32, 1e-5 relative to the largest entry)."""
    T, Td, u = _jet_points(1)

    def step_vec(x, uu):
        return torch.stack(tjm.step(x[0], x[1], uu, DT))

    x64 = torch.stack([_t(T), _t(Td)], dim=-1).double()
    u64 = _t(u).double()
    A, Bm = tjm.step_jacobians(x64, u64, DT)
    assert A.shape == (len(T), 2, 2) and Bm.shape == (len(T), 2)
    for i in range(len(T)):
        A_ad, B_ad = torch.func.jacfwd(step_vec, argnums=(0, 1))(x64[i],
                                                                 u64[i])
        torch.testing.assert_close(A[i], A_ad, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(Bm[i], B_ad, rtol=1e-10, atol=1e-10)
    A32, B32 = tjm.step_jacobians(x64.float(), u64.float(), DT)
    jA, jB = jax.vmap(lambda x, uu: jjm.step_jacobians(x, uu, DT))(
        jnp.asarray(x64.float().numpy()), jnp.asarray(u))
    np.testing.assert_allclose(A32.numpy(), np.asarray(jA), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(B32.numpy(), np.asarray(jB), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# LSTM jet model and EKF
# ---------------------------------------------------------------------------


def test_lstm_step_matches_jax():
    """[3 lanes, 4 jets] through the zero-state cell; 1e-5 relative."""
    rng = np.random.default_rng(2)
    thrust = rng.uniform(0, 220, (3, 4)).astype(np.float32)
    throttle = rng.uniform(0, 100, (3, 4)).astype(np.float32)
    ours = TLSTM(WEIGHTS, device="cpu")
    theirs = JLSTM(WEIGHTS)
    got = ours.step(_t(thrust), _t(throttle), DT)
    ref = theirs.step(jnp.asarray(thrust), jnp.asarray(throttle), DT)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5,
                               atol=1e-3)
    assert isinstance(ours, torch.nn.Module)
    assert set(dict(ours.named_buffers())) == {"w_ih", "w_hh", "b", "fc_w",
                                               "fc_b"}
    assert not list(ours.parameters())


def test_lstm_from_numpy_equals_the_file_model():
    raw = dict(np.load(WEIGHTS))
    a = convert.lstm_from_numpy(raw, "cpu")
    b = TLSTM(WEIGHTS, device="cpu")
    for (ka, va), (kb, vb) in zip(a.named_buffers(), b.named_buffers()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert (a.thrust_mean, a.thrust_std, a.throttle_mean, a.throttle_std) == \
        (b.thrust_mean, b.thrust_std, b.throttle_mean, b.throttle_std)


def test_ekf_matches_jax_over_50_steps():
    """Two lanes × four jets, 50 updates with numpy-seeded throttle and
    measurements; state within 1e-4 relative, covariance within 1e-5."""
    rng = np.random.default_rng(4)
    jekf, tekf = JJetEKF(DT), TJetEKF(DT, device="cpu")
    t0 = rng.uniform(10, 150, (2, 4)).astype(np.float32)
    js, ts = jekf.init(jnp.asarray(t0)), tekf.init(t0)
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    np.testing.assert_array_equal(ts.P.numpy(), np.asarray(js.P))
    jupdate = jax.jit(jekf.update)
    for _ in range(50):
        u = rng.uniform(0, 100, (2, 4)).astype(np.float32)
        z = (t0 + rng.normal(0, 2.0, (2, 4))).astype(np.float32)
        zd = rng.normal(0, 20.0, (2, 4)).astype(np.float32)
        js = jupdate(js, jnp.asarray(u), jnp.asarray(z), jnp.asarray(zd))
        ts = tekf.update(ts, _t(u), _t(z), _t(zd))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# plant
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plants():
    """Both plants on the calibrated model with the LSTM+EKF jets on, and two
    JAX states: standing (ground contact active) and airborne with every
    scenario perturbation set; velocities are numpy-seeded."""
    jkd = jdyn.KinDyn(jdyn.load_ironcub_model())
    tkd = tdyn.KinDyn(tdyn.load_ironcub_model(), device="cpu")
    jplant = JPlant(jkd, RobotConfig(), SimConfig(), JPlantParams(kd=60.0),
                    lstm=JLSTM(WEIGHTS))
    tplant = TPlant(tkd, tconfig.RobotConfig(), tconfig.SimConfig(),
                    TPlantParams(kd=60.0), lstm=TLSTM(WEIGHTS, device="cpu"))
    rng = np.random.default_rng(5)
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    s0 = jflight.standing_state(jplant, SimConfig().initial_position_deg)
    n, L = jkd.n, jkd.L
    ground = s0._replace(
        base_p=s0.base_p - f([0.0, 0.0, 0.004]),   # soles 2 mm into the ground
        base_v=f(rng.normal(0, 0.05, 6)), qd=f(rng.normal(0, 0.2, n)),
        throttle=f(rng.uniform(20, 60, 4)),
        q_des=s0.q + f(rng.normal(0, 0.02, n)))
    air = s0._replace(
        base_p=s0.base_p + f([0.1, -0.05, 0.6]),
        base_v=f(rng.normal(0, 0.3, 6)), qd=f(rng.normal(0, 0.3, n)),
        q=s0.q + f(rng.normal(0, 0.1, n)),
        throttle=f(rng.uniform(40, 90, 4)),
        thrust_nn=f(rng.uniform(80, 180, 4)),
        ekf=jplant.ekf.init(f(rng.uniform(80, 180, 4))),
        wind_force=f(rng.normal(0, 2.0, 3)),
        thrust_scale=f(rng.uniform(0.95, 1.05, 4)),
        mass_scale=f(rng.uniform(0.95, 1.05, L)),
        jet_pos_offset=f(rng.normal(0, 0.005, (4, 3))))
    return jplant, tplant, {"ground": ground, "air": air}


def _to_port(state):
    return convert.plant_state_from_numpy(_np(state._replace(rng=None)), "cpu")


def _states_close(got: TPlantState, ref, tol, what):
    ref = _np(ref._replace(rng=None))
    for name in TPlantState._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if name == "rng":
            assert g is None
        elif name == "ekf":
            for k in ("x", "P"):
                np.testing.assert_allclose(
                    getattr(g, k)[0].numpy(), getattr(r, k), rtol=tol,
                    atol=tol * max(float(np.abs(getattr(r, k)).max()), 1.0),
                    err_msg=f"{what}: ekf.{k}")
        else:
            np.testing.assert_allclose(
                g[0].numpy(), r, rtol=tol,
                atol=tol * max(float(np.abs(r).max()), 1.0),
                err_msg=f"{what}: {name}")


def test_init_state_and_standing_state_match(plants):
    jplant, tplant, _ = plants
    q0_deg = SimConfig().initial_position_deg
    jq, jz = jflight.standing_geometry(jplant.kd, q0_deg)
    tq, tz = tflight.standing_geometry(tplant.kd, q0_deg)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=0)
    assert abs(tz - jz) < 1e-6
    js = jflight.standing_state(jplant, q0_deg)
    ts = tflight.standing_state(tplant, q0_deg, batch=3)
    assert ts.q.shape == (3, jplant.kd.n) and ts.rng is None
    _states_close(ts, js, 1e-6, "standing_state")
    torch.testing.assert_close(ts.base_p[2], ts.base_p[0], rtol=0, atol=0)


@pytest.mark.parametrize("which", ["ground", "air"])
def test_substeps_and_sole_wrenches_match_from_converted_state(plants, which):
    """5 substeps (one control period) and the FT-sensor readout from the
    same state: 1e-5 relative to each field's largest magnitude."""
    jplant, tplant, states = plants
    js = states[which]
    ts = _to_port(js)
    _states_close(ts, js, 0.0, "converted")
    jw = np.asarray(jax.jit(jplant.sole_wrenches)(js))
    tw = tplant.sole_wrenches(ts)[0].numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-5,
                               atol=1e-5 * max(np.abs(jw).max(), 1.0))
    if which == "ground":
        assert jw[:, 2].min() > 10.0       # contact is really active
    else:
        assert np.all(jw == 0.0)
    js5 = jax.jit(lambda s: jplant.step(s, 5))(js)
    ts5 = tplant.step(ts, 5)
    _states_close(ts5, js5, 1e-5, f"{which} after 5 substeps")
    np.testing.assert_allclose(tplant.applied_thrust(ts5)[0].numpy(),
                               np.asarray(jplant.applied_thrust(js5)),
                               rtol=1e-5)


def test_lanes_step_independently(plants):
    """Two different states stacked as two lanes step as they do alone."""
    _, tplant, states = plants
    a, b = _to_port(states["ground"]), _to_port(states["air"])

    def stack(x, y):
        if isinstance(x, tuple):
            return type(x)(*(stack(u, v) for u, v in zip(x, y)))
        return None if x is None else torch.cat([x, y], dim=0)

    both = tplant.substep(stack(a, b))
    for lane, one in enumerate((tplant.substep(a), tplant.substep(b))):
        for name in ("base_R", "base_p", "base_v", "q", "qd", "thrust_nn"):
            torch.testing.assert_close(getattr(both, name)[lane],
                                       getattr(one, name)[0], rtol=1e-6,
                                       atol=1e-6)


def test_direct_thrust_plant_and_setters(plants):
    """use_nn_jet_dynamics=False: the commanded thrust is applied and the
    jet states are left alone; the setters replace their field only."""
    _, tplant, states = plants
    plant = TPlant(tplant.kd, tconfig.RobotConfig(),
                   tconfig.SimConfig(use_nn_jet_dynamics=False))
    s = _to_port(states["air"])
    cmd = torch.full((1, 4), 150.0)
    s = plant.set_thrust(s, cmd)
    s = plant.set_throttle(s, torch.full((1, 4), 33.0))
    s = plant.set_joint_positions(s, s.q + 0.01)
    assert torch.equal(plant.applied_thrust(s), cmd)
    assert torch.equal(tplant.applied_thrust(s), s.ekf.x[..., 0])
    s2 = plant.substep(s)
    assert torch.equal(s2.thrust_nn, s.thrust_nn)
    assert torch.equal(s2.ekf.x, s.ekf.x)
    assert torch.equal(s2.throttle, s.throttle)
    assert torch.isfinite(s2.q).all() and not torch.equal(s2.q, s.q)
    # more thrust lifts the base faster
    s_hi = plant.substep(plant.set_thrust(s, cmd * 1.5))
    assert float(s_hi.base_v[0, 2]) > float(s2.base_v[0, 2])


def test_sensor_noise_statistics(plants):
    """As tests/test_sim.py::test_sensor_noise_statistics: Gaussian noise of
    the configured std on all six channels, distinct draws per call, the
    same draws again after re-seeding; with noise off the reading is
    exact."""
    _, tplant, _ = plants
    sim_cfg = tconfig.SimConfig(use_nn_jet_dynamics=False, simulate_noise=True)
    plant = TPlant(tplant.kd, tconfig.RobotConfig(), sim_cfg)

    def draws(seed):
        s = plant.init_state(np.eye(3), np.array([0.0, 0.0, 0.8]),
                             np.zeros(plant.kd.n), seed=seed)
        out = []
        for _ in range(400):
            lin, ang, s = plant.measured_base_velocity(s)
            out.append(torch.cat([lin, ang], dim=-1)[0].numpy())
        return np.stack(out)

    samples = draws(0)
    assert samples.std(axis=0).min() > 0.5 * sim_cfg.noise_std_base_vel
    np.testing.assert_allclose(samples.std(axis=0),
                               sim_cfg.noise_std_base_vel, rtol=0.35)
    np.testing.assert_allclose(samples.mean(axis=0), 0.0, atol=5e-3)
    assert not np.allclose(samples[0], samples[1])
    np.testing.assert_array_equal(draws(0), samples)
    assert not np.allclose(draws(1), samples)
    s = tplant.init_state(np.eye(3), np.zeros(3), np.zeros(tplant.kd.n))
    s = s._replace(base_v=torch.arange(6.0)[None])
    lin, ang, _ = tplant.measured_base_velocity(s)
    assert lin.tolist() == [[0.0, 1.0, 2.0]]
    assert ang.tolist() == [[3.0, 4.0, 5.0]]
