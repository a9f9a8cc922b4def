"""The port's closed-loop flight against the plain float64 reference
``tests/flight_oracle.py`` on the CPU: the LSTM jet model, the EKF, the
1 kHz plant substep, the snapshot, the mass matrix, CoM and mass, and five
whole ``ClosedLoop.tick``\\ s from a recorded start. The port runs in
float32 with ``kernel_mode="off"``; the reference shares no code with it
(its own URDF parser, re-rooting, Jacobians and Newton-Euler bias forces).

Each tolerance is stated beside its assert with its reason. Most are a
float32 rounding budget: the relative error of float32 (6e-8 a rounding)
times the size of the quantity and the depth of the computation that
feeds it, with room; a bfloat16 plant misses them by orders of
magnitude (``PERF.md``). The benchmark's copy of the reference
(``mpcbench/reference/flight.py``) is this file below its first line.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flight_oracle as fo

from ironcub_mpc_tpu_torch.dynamics import KinDyn
from ironcub_mpc_tpu_torch.dynamics.kinodynamics import compute_snapshot
from ironcub_mpc_tpu_torch.runtime import checkpoint, flight
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
from ironcub_mpc_tpu_torch.sim.ekf import EKFState
from ironcub_mpc_tpu_torch.sim.jet_lstm import LSTMJetModel
from ironcub_mpc_tpu_torch.sim.plant import Plant, PlantState

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "mpcbench" / "configs" / "mk3_flight.json"
STREAMS = ROOT / "mpcbench" / "streams"
WEIGHTS = ROOT / "data" / "jet_lstm_weights.npz"
SEEDS = (11, 12, 13, 14, 15, 16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager PyTorch on one thread: several test processes share the
    cores, and a thread a core makes each small op wait."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def loop():
    """The port's flight loop on the CPU at the flight's settings, the
    kernels' plain path."""
    lp, pos, alpha = flight.build_flight_loop(device="cpu")
    lp.settings = dataclasses.replace(lp.settings, kernel_mode="off")
    return lp, pos, alpha


@pytest.fixture(scope="module")
def ref():
    return fo.Flight(CONFIG, np.load(STREAMS / "flight_start.npz"))


def plant_of(loop_, dtype):
    """The flight's plant in ``dtype`` (its model, LSTM and EKF)."""
    lp = loop_[0]
    kd = KinDyn(lp.kd.model, dtype=dtype, device="cpu")
    return Plant(kd, lp.robot_cfg, lp.plant.sim_cfg, params=lp.plant.params,
                 lstm=LSTMJetModel(str(WEIGHTS), dtype=dtype, device="cpu"))


def random_state(ref_, seed, contact):
    """A plant state of the reference's fields drawn from ``seed``: joints
    around the initial posture, the base turned and moving, jets between
    idle and full thrust; with ``contact``, the base lowered until the
    lowest sole corner is 3 mm below the ground, else 0.5 m above it."""
    rng = np.random.default_rng(seed)
    q0 = np.radians(np.asarray(ref_.config["sim"]["initial_position_deg"]))
    q = q0 + 0.2 * rng.standard_normal(23)
    R = fo._exp(fo._t(0.2 * rng.standard_normal(3)))
    kin = fo.kinematics(ref_.robot, R, fo._t(np.zeros(3)), fo._t(q))
    low = min(float((kin.p[s] + (kin.R[s] @ ref_.corners.T).T)[:, 2].min())
              for s in ref_.soles)
    z = -low - 0.003 if contact else -low + 0.5
    T = 60.0 + 150.0 * rng.random(4)
    st = dict(base_R=R, base_p=fo._t([0.02, -0.01, z]),
              base_v=fo._t(0.2 * rng.standard_normal(6)), q=fo._t(q),
              qd=fo._t(0.5 * rng.standard_normal(23)),
              thrust_nn=fo._t(T),
              ekf_x=fo._t(np.stack([T + rng.standard_normal(4),
                                    40.0 * rng.standard_normal(4)], -1)),
              ekf_P=fo._t(np.stack([[[0.3, 0.05], [0.05, 0.4]]] * 4)),
              throttle=fo._t(20.0 + 70.0 * rng.random(4)),
              q_des=fo._t(q + 0.05 * rng.standard_normal(23)))
    return st, fo._t(2.0 * rng.standard_normal(3))


def port_state(st, wind, dtype, links):
    """The reference's state as the port's ``PlantState`` of one lane."""
    def t(k):
        return st[k].to(dtype)[None]
    return PlantState(
        base_R=t("base_R"), base_p=t("base_p"), base_v=t("base_v"),
        q=t("q"), qd=t("qd"), thrust_nn=t("thrust_nn"),
        ekf=EKFState(x=t("ekf_x"), P=t("ekf_P")), throttle=t("throttle"),
        q_des=t("q_des"), thrust_cmd=t("thrust_nn"), rng=None,
        wind_force=wind.to(dtype)[None],
        thrust_scale=torch.ones((1, 4), dtype=dtype),
        mass_scale=torch.ones((1, links), dtype=dtype),
        jet_pos_offset=torch.zeros((1, 4, 3), dtype=dtype))


def as_ref(s: PlantState) -> dict:
    """One lane of a port state as the reference's float64 fields."""
    return dict(base_R=s.base_R[0], base_p=s.base_p[0], base_v=s.base_v[0],
                q=s.q[0], qd=s.qd[0], thrust_nn=s.thrust_nn[0],
                ekf_x=s.ekf.x[0], ekf_P=s.ekf.P[0], throttle=s.throttle[0],
                q_des=s.q_des[0])


def gaps(got: dict, want: dict) -> dict:
    return {k: float((got[k].double() - want[k]).abs().max())
            for k in fo.PLANT_FIELDS}


# the substep's float32 budget: a state after one 1 kHz step. Positions and
# angles move by dt·ν, so their rounding is float32's on O(1) values
# (~1e-7); velocities carry the solve of (M + dt·D) ν̇ = τ − D ν − h times
# dt, with τ a few thousand N from the contact springs (6e4 N/m) and the PD
# (1500): ~1e-6 on the base, ~1e-5 on the joints; the jets round on ~200 N
# (~2e-5 N) and pass through the EKF's gain. Measured over these twelve
# states: 9e-8 (poses), 1.4e-6 (base velocity), 8.5e-6 (joint velocity),
# 2.2e-5 (LSTM and EKF thrust); each tolerance keeps about ten times that.
# A bfloat16 plant misses every one, a float16 plant too (PERF.md).
SUBSTEP_TOL = dict(base_R=1e-6, base_p=1e-6, base_v=2e-5, q=1e-6, qd=1e-4,
                   thrust_nn=2e-4, ekf_x=2e-4, ekf_P=1e-6, throttle=1e-5,
                   q_des=1e-6)


def substep_gaps(loop_, ref_, seed, contact, dtype=torch.float32):
    st, wind = random_state(ref_, seed, contact)
    plant = plant_of(loop_, dtype)
    got = plant.substep(port_state(st, wind, dtype, plant.kd.L))
    want = ref_.substep(st, wind)
    return gaps(as_ref(got), want)


@pytest.mark.parametrize("contact", [True, False], ids=["contact", "air"])
@pytest.mark.parametrize("seed", SEEDS)
def test_substep_matches_reference(loop, ref, seed, contact):
    g = substep_gaps(loop, ref, seed, contact)
    over = {k: (v, SUBSTEP_TOL[k]) for k, v in g.items()
            if v > SUBSTEP_TOL[k]}
    assert not over, over


def test_contact_states_touch_the_ground(ref):
    """The ``contact`` states do load the soles: some corner pushes."""
    for seed in SEEDS:
        st, _ = random_state(ref, seed, True)
        kin = fo.kinematics(ref.robot, st["base_R"], st["base_p"], st["q"])
        nu = torch.cat([st["base_v"], st["qd"]])
        assert float(ref._contact(kin, nu)[1][..., 2].max()) > 10.0


def write_weights(path, rng):
    """Seeded random LSTM weights at the published widths (2→80, FC
    80→1) and the published normalisation, in the weights file's layout."""
    H = 80
    z = dict(np.load(WEIGHTS))
    z.update(w_ih=0.5 * rng.standard_normal((4 * H, 2)),
             w_hh=0.1 * rng.standard_normal((4 * H, H)),
             b_ih=0.1 * rng.standard_normal(4 * H),
             b_hh=0.1 * rng.standard_normal(4 * H),
             fc_w=0.3 * rng.standard_normal((1, H)),
             fc_b=0.1 * rng.standard_normal(1))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in z.items()})
    return path


@pytest.mark.parametrize("weights", ["random", "published"])
def test_lstm_matches_reference(weights, tmp_path):
    rng = np.random.default_rng(3)
    path = (WEIGHTS if weights == "published"
            else write_weights(tmp_path / "w.npz", rng))
    port = LSTMJetModel(str(path), device="cpu")
    refm = fo.LSTMJets(path)
    T = 10.0 + 210.0 * rng.random((64, 4))
    u = 100.0 * rng.random((64, 4))
    got_T, got_Td = port.step(torch.as_tensor(T, dtype=torch.float32),
                              torch.as_tensor(u, dtype=torch.float32), 1e-3)
    want = [refm.step(fo._t(a), fo._t(b), 1e-3) for a, b in zip(T, u)]
    want_T = torch.stack([w[0] for w in want])
    want_Td = torch.stack([w[1] for w in want])
    # T is ~200 N (float32 rounding 1.5e-5) moved by dt·Ṫ; Ṫ is the FC
    # head's sum of 80 products of O(1) times the thrust's σ (65.8 N):
    # ~1e-6 relative, 1e-4 N/s at these rates
    assert float((got_T.double() - want_T).abs().max()) < 1e-4
    assert float((got_Td.double() - want_Td).abs().max()) < 2e-3


def test_ekf_update_matches_reference(loop):
    ekf = loop[0].plant.ekf
    rng = np.random.default_rng(5)
    T = 50.0 + 170.0 * rng.random((32, 4))
    x = np.stack([T, 60.0 * rng.standard_normal((32, 4))], -1)
    P = np.tile([[0.3, 0.05], [0.05, 0.4]], (32, 4, 1, 1))
    u = 100.0 * rng.random((32, 4))
    z = np.stack([T + rng.standard_normal((32, 4)),
                  x[..., 1] + 5.0 * rng.standard_normal((32, 4))], -1)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    got = ekf.update(EKFState(f32(x), f32(P)), f32(u), f32(z[..., 0]),
                     f32(z[..., 1]))
    ek = json.loads(CONFIG.read_text())["ekf"]
    for i in range(32):
        wx, wP = fo.ekf_update(fo._t(x[i]), fo._t(P[i]), fo._t(u[i]),
                               fo._t(z[i]), 1e-3,
                               ek["r"] * torch.eye(2, dtype=fo.F64),
                               ek["q"] * torch.eye(2, dtype=fo.F64))
        # (T, Ṫ) of ~200 N and ~100 N/s: float32 rounding of the
        # prediction and of the gain, a few 1e-5 N and 1e-4 N/s
        assert float((got.x[i].double() - wx).abs().max()) < 5e-4
        # P of O(0.1), a few float32 roundings
        assert float((got.P[i].double() - wP).abs().max()) < 1e-6


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_snapshot_and_mass_matrix_match_reference(loop, ref, seed):
    st, _ = random_state(ref, seed, contact=seed % 2 == 0)
    kd = loop[0].kd
    f = {k: v.float()[None] for k, v in st.items()}
    snap = compute_snapshot(kd, loop[0].robot_cfg.jets_list, f["base_R"],
                            f["base_p"], f["base_v"], f["q"], f["qd"],
                            f["ekf_x"][..., 0])
    want = ref.snapshot(st)
    # lengths of O(1) m, directions and Jacobian columns: float32 on O(1)
    # through a 6-link chain, a few 1e-7
    for k in ("com_pos", "jet_axes_world", "jet_arms_world", "rel_jac_lin",
              "rel_jac_ang", "jac_com_joints", "w_R_b"):
        got = getattr(snap, k)[0].double().numpy()
        assert np.abs(got - want[k]).max() < 2e-6, k
    # the momentum sums 35 links' m·v and I·ω (~10 kg·m/s): 1e-5
    assert np.abs(snap.momentum_body[0].double().numpy()
                  - want["momentum_body"]).max() < 2e-5
    # the locked inertia of ~10 kg·m², 1e-6 relative
    assert np.abs(snap.inertia_locked[0].double().numpy()
                  - want["inertia_locked"]).max() < 1e-5
    assert float(snap.total_mass[0]) == pytest.approx(70.0, abs=1e-4)
    assert ref.robot.total_mass == pytest.approx(70.0, abs=1e-9)
    # the mass matrix (entries up to the 70 kg mass) and the CoM
    ls = kd.fk(f["base_R"], f["base_p"], f["q"])
    J = kd.link_spatial_jacobians(ls, f["base_p"])
    I_sp, c_w, _ = kd.link_spatial_inertias(ls)
    kin = fo.kinematics(ref.robot, st["base_R"], st["base_p"], st["q"])
    dyn = fo.dynamics(ref.robot, kin, torch.cat([st["base_v"], st["qd"]]),
                      ref.gravity)
    M = kd.mass_matrix(J, I_sp)[0].double()
    assert float((M - dyn.M).abs().max()) < 5e-5      # ~1e-6 of 70 kg
    assert float((M - M.T).abs().max()) < 1e-5
    assert float((kd.com(c_w)[0].double()
                  - fo._t(want["com_pos"])).abs().max()) < 1e-6


def test_reference_dynamics_are_exact_in_float64(loop, ref):
    """In float64 the port's mass matrix and bias forces equal the
    reference's to rounding, on an orthonormal base rotation: the two
    formulations (world-origin Plücker and path Jacobians with
    Newton-Euler) agree exactly."""
    st, _ = random_state(ref, 21, contact=False)
    kd = KinDyn(loop[0].kd.model, dtype=torch.float64, device="cpu")
    ls = kd.fk(st["base_R"][None], st["base_p"][None], st["q"][None])
    J = kd.link_spatial_jacobians(ls, st["base_p"][None])
    I_sp, _, _ = kd.link_spatial_inertias(ls)
    nu = torch.cat([st["base_v"], st["qd"]])
    h = kd.bias_forces(J, I_sp, ls, st["base_p"][None], nu[None],
                       fo._t(ref.gravity))[0]
    dyn = fo.dynamics(ref.robot, fo.kinematics(ref.robot, st["base_R"],
                                               st["base_p"], st["q"]),
                      nu, ref.gravity)
    assert float((kd.mass_matrix(J, I_sp)[0] - dyn.M).abs().max()) < 1e-12
    assert float((h - dyn.h).abs().max()) < 1e-10


def test_five_ticks_from_a_recorded_start(loop):
    """Five whole closed-loop ticks of the port from the recorded takeoff
    state beside the reference's own five (its exact controller solve,
    its plant), the same wind."""
    lp, pos, alpha = loop
    z = np.load(STREAMS / "flight_start.npz")
    settled = checkpoint.unflatten(
        {k: torch.as_tensor(z[k]) for k in z.files if k.startswith("plant.")},
        "plant", flight.standing_state(lp.plant,
                                       lp.plant.sim_cfg.initial_position_deg))
    problem, carry0 = lp.configure(settled, *flight.mission_inputs(pos, alpha))
    zt = np.load(STREAMS / "flight_takeoff.npz")
    carry = checkpoint.unflatten(
        {k: torch.as_tensor(zt[k]) for k in zt.files
         if k.startswith("carry.")}, "carry", carry0)
    wind = np.array([1.5, -0.5, 0.8])
    carry = carry._replace(plant=carry.plant._replace(
        wind_force=torch.as_tensor(wind[None], dtype=torch.float32)))
    before = (ClosedLoop.tick.ticks, Plant.substep.substeps)
    outs = []
    for _ in range(5):
        carry, tel = lp.tick(problem, carry)
        outs.append((tel, carry.plant))
        assert int(tel.solver_status[0]) in (1, 2)
    assert (ClosedLoop.tick.ticks - before[0],
            Plant.substep.substeps - before[1]) == (5, 25)
    want = fo.chain_pass(CONFIG, STREAMS / "flight_start.npz",
                         STREAMS / "flight_takeoff.npz", wind, 5)
    for (tel, p), w in zip(outs, want):
        cmd = w["commands"]
        # the port's ADMM stops at eps 1e-4 where the reference solves
        # exactly: joint steps ~1e-5 rad, throttle ~1e-3 %, thrust ~1e-4 N,
        # its rate ~1e-2 N/s, compounding over five ticks
        assert np.abs(tel.joints_pos_ref[0].double().numpy()
                      - cmd["joints_pos_ref"]).max() < 2e-4
        assert np.abs(tel.throttle[0].double().numpy()
                      - cmd["throttle"]).max() < 0.02
        assert np.abs(tel.thrust_desired[0].double().numpy()
                      - cmd["thrust_des"]).max() < 2e-3
        assert np.abs(tel.thrust_desired_dot[0].double().numpy()
                      - cmd["thrust_dot_des"]).max() < 0.1
        nxt = w["next"]
        # the state after a tick from commands that differ as above:
        # positions ~1e-6, velocities ~1e-3, the jets ~1e-3 N
        assert np.abs(p.base_p[0].double().numpy() - nxt["base_p"]).max() \
            < 1e-5
        assert np.abs(p.q[0].double().numpy() - nxt["q"]).max() < 1e-4
        assert np.abs(p.qd[0].double().numpy() - nxt["qd"]).max() < 0.02
        assert np.abs(p.ekf.x[0].double().numpy()
                      - nxt["ekf_x"]).max() < 0.2


def test_benchmark_copy_is_this_reference():
    copy = (ROOT / "mpcbench" / "reference" / "flight.py").read_text()
    first, rest = copy.split("\n", 1)
    assert first.startswith("# Frozen copy of tests/flight_oracle.py")
    assert rest == (ROOT / "tests" / "flight_oracle.py").read_text()


def test_configuration_states_the_flight_defaults(loop):
    """``mk3_flight.json`` states exactly what ``build_flight_loop`` flies
    at its defaults: the MPC configuration, the solver (but the traffic's
    ``batch_guard``), the plant, the simulator and the EKF."""
    lp = loop[0]
    config = json.loads(CONFIG.read_text())

    def plain(d):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in d.items()}

    cfg = plain(dataclasses.asdict(lp.cfg))
    assert {k: cfg[k] for k in config["mpc"]} == config["mpc"]
    solver = plain(dataclasses.asdict(lp.settings))
    solver.pop("batch_guard")
    assert solver == dict(config["solver"], kernel_mode="off")
    assert dataclasses.asdict(lp.plant.params) == config["plant"]
    sim = plain(dataclasses.asdict(lp.plant.sim_cfg))
    assert {k: sim[k] for k in config["sim"]} == config["sim"]
    ek = lp.plant.ekf
    assert [float(ek.R[0, 0]), float(ek.Q[0, 0]), float(ek.P0[0, 0])] == \
        pytest.approx([config["ekf"][k] for k in ("r", "q", "p0")],
                      rel=1e-7)      # the EKF keeps them in float32
    assert list(lp.robot_cfg.axes_list) == config["robot"]["axes_list"]
    assert list(lp.robot_cfg.jets_list) == config["robot"]["jets_list"]


def test_recorded_starts_carry_their_origin():
    for name, tick in (("flight_start", 0), ("flight_takeoff", 2700),
                       ("flight_airborne", 4400)):
        z = np.load(STREAMS / f"{name}.npz")
        assert int(z["meta_tick"]) == tick
        assert str(z["meta_dtype"]) == "float32"
        assert len(str(z["meta_commit"])) >= 40 and str(z["meta_device"])
