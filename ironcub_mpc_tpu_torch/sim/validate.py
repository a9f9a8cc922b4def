"""Cross-engine plant validation: one controller, two physics engines
(counterpart of ``ironcub_mpc_tpu/sim/validate.py``).

Runs the SAME closed-loop MPC (same config, settings, trajectory, initial
state) once against the port's plant (:mod:`.plant`) and once against host
MuJoCo (:mod:`.mujoco_sim` — the reference's plant,
mujoco_lib/ironcub_mujoco_simulator.py:122-139), then reports per-tick
CoM / attitude / base-position divergence. This bounds how far the port's
plant drifts from MuJoCo's physics: if the penalty-contact/PD model were
off, every Monte-Carlo sweep would sweep the wrong physics.

Where the two plants deliberately differ (the divergence these bounds
absorb):

- **Contacts** — MuJoCo solves a complementarity problem with its soft
  constraint model; the port's plant uses penalty springs at four
  sole-corner points (``PlantParams.contact_kp/kd``) with smooth Coulomb
  friction. Standing equilibrium therefore differs by O(mm) in penetration
  depth and load distribution.
- **Integration** — MuJoCo semi-implicit Euler with implicit actuator/
  damping terms vs. the plant's semi-implicit Euler with implicit
  *joint-damping only* (plant.substep). Both run at the same 1 kHz.
- **Actuation** — the generated MJCF's position servos (kp=1500, joint
  damping 60; sim/mjcf.py) match ``PlantParams(kp=1500, kd=60)`` by
  construction, so PD torques agree to actuator-model differences.
- **Jets** — identical by construction: the same LSTM+EKF chain runs in
  both (sim/jet_lstm.py, sim/ekf.py), and thrust enters both as a pure
  force along the jet site's −z axis.

The divergence is measured in closed loop, so controller feedback partially
compensates plant differences — exactly the regime the sweeps run in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.config import MPCConfig, RobotConfig, SimConfig, joint_selector
from ..horizon.schedule import build_schedule
from ..ops import admm
from ..ops.so3 import matrix_to_rpy
from ..qp import mpc as vs_mpc
from ..runtime.flight import standing_geometry as _standing_geometry


class PlantTrace(NamedTuple):
    """Per-tick channels recorded at the pre-step snapshot (same sampling
    point as runtime.loop.TickTelemetry), on the host."""

    com: np.ndarray        # [T, 3]
    rpy: np.ndarray        # [T, 3] rad
    base_p: np.ndarray     # [T, 3]
    thrust: np.ndarray     # [T, 4] estimated/applied thrust
    status: np.ndarray     # [T]


def _hold_channels():
    return {k: np.zeros((30, 3)) for k in
            ("positionCoM", "velocityCoM", "RPY", "RPYDot")}


def run_torch_plant(kd, cfg: MPCConfig, settings, sim_cfg: SimConfig, lstm,
                    alpha, n_ticks: int, settle_s: float) -> PlantTrace:
    """Closed loop over the port's plant (``ClosedLoop.rollout``) on the
    device of ``kd``."""
    from ..runtime.loop import ClosedLoop
    from .plant import Plant, PlantParams

    # kd=60 matches the generated MJCF's joint damping (sim/mjcf.py)
    plant = Plant(kd, RobotConfig(), sim_cfg,
                  params=PlantParams(kd=60.0), lstm=lstm)
    loop = ClosedLoop(plant, cfg, settings)
    q0, z_min = _standing_geometry(kd, sim_cfg.initial_position_deg)
    s = plant.init_state(np.eye(3), np.array([0.0, 0.0, -z_min]), q0)
    s = loop.settle(s, settle_s)
    problem, carry = loop.configure(s, _hold_channels(), alpha)
    carry, tel = loop.rollout(problem, carry, n_ticks)

    def lane0(t):
        return t[:, 0].cpu().numpy()

    return PlantTrace(
        com=lane0(tel.com_position), rpy=lane0(tel.base_orientation),
        base_p=lane0(tel.base_position), thrust=lane0(tel.estimated_thrust),
        status=lane0(tel.solver_status))


def run_mujoco_plant(kd, cfg: MPCConfig, settings, sim_cfg: SimConfig, lstm,
                     alpha, n_ticks: int, settle_s: float) -> PlantTrace:
    """The same closed loop over host MuJoCo, tick structure mirroring
    runtime.loop.ClosedLoop.tick: snapshot → solve → apply → 5 substeps.
    A tick copies the snapshot's inputs to the device once and the
    commands and the recorded channels back once."""
    from .mujoco_sim import HostMujocoSim

    sim = HostMujocoSim(kd, RobotConfig(), sim_cfg, lstm=lstm)
    q0, z_min = _standing_geometry(kd, sim_cfg.initial_position_deg)
    sim.set_state(np.eye(3), [0.0, 0.0, -z_min], q0)
    sim.set_joint_positions(q0)
    sim.set_thrust(np.full(4, 10.0))
    sim.step(int(round(settle_s / sim_cfg.timestep)))

    sched = build_schedule(cfg)
    sel = joint_selector(RobotConfig(), cfg)
    snap = sim.snapshot()
    problem, carry = vs_mpc.configure(
        cfg, sched, sel, snap, _hold_channels(), alpha, settings,
        est_thrust_dot=sim.get_estimated_thrust_dot(),
        initial_throttle=sim._throttle, device=kd.device, dtype=kd.dtype)
    n_sub = int(round(cfg.period_mpc / sim_cfg.timestep))
    n = kd.n

    com, rpy, base_p, thrust, status = [], [], [], [], []
    for _ in range(n_ticks):
        snap = sim.snapshot()
        carry, out = vs_mpc.mpc_tick(cfg, sched, sel, settings, problem,
                                     carry, snap, sim.estimated_thrust_dot())
        host = torch.cat([
            out.joints_pos_ref[0], out.throttle[0], out.thrust_des[0],
            out.status.to(kd.dtype), snap.com_pos[0],
            matrix_to_rpy(snap.w_R_b)[0]]).cpu().numpy()
        if not sim_cfg.use_nn_jet_dynamics:
            sim.set_thrust(host[n + 4:n + 8])
        sim.set_joint_positions(host[:n])
        sim.set_throttle(host[n:n + 4])
        com.append(host[n + 9:n + 12])
        rpy.append(host[n + 12:n + 15])
        base_p.append(sim.get_base_position())
        thrust.append(sim.get_estimated_thrust())
        status.append(int(host[n + 8]))
        sim.step(n_sub)
    return PlantTrace(com=np.stack(com), rpy=np.stack(rpy),
                      base_p=np.stack(base_p), thrust=np.stack(thrust),
                      status=np.asarray(status))


def compare_plants(n_ticks: int = 400, settle_s: float = 1.0,
                   use_nn: bool = True, alpha_ramp: bool = True,
                   max_iter: int = 120, device=None) -> dict:
    """Run both engines and report divergence statistics.

    Default scenario: standing + the early alphaGravity ramp with NN jets +
    EKF on — thrust builds from idle toward weight support while ground
    contact carries the remainder. Runs on ``cuda`` unless ``device`` says
    otherwise.
    """
    from pathlib import Path

    from ..dynamics import KinDyn, load_ironcub_model
    from .jet_lstm import LSTMJetModel

    dev = resolve_device(device)
    root = Path(__file__).resolve().parents[2]
    model = load_ironcub_model()
    kd = KinDyn(model, device=dev)
    cfg = MPCConfig()
    settings = admm.ADMMSettings(max_iter=max_iter,
                                 rho_update_iters=(20, 50))
    sim_cfg = SimConfig(use_nn_jet_dynamics=use_nn)
    lstm = (LSTMJetModel(str(root / "data/jet_lstm_weights.npz"), device=dev)
            if use_nn else None)
    if alpha_ramp:
        from ..runtime.trajectory import load_npz

        traj = load_npz(str(root / "data/trajectories/alpha_gravity.npz"),
                        des_fps=1.0 / cfg.period_mpc)
        alpha = np.asarray(traj.channels["alphaGravity"])[:, 0]
    else:
        alpha = np.full(max(n_ticks + 10, 600), 0.08)

    a = run_torch_plant(kd, cfg, settings, sim_cfg, lstm, alpha,
                        n_ticks, settle_s)
    b = run_mujoco_plant(kd, cfg, settings, sim_cfg, lstm, alpha,
                         n_ticks, settle_s)

    d_com = np.linalg.norm(a.com - b.com, axis=1)
    d_rpy = np.degrees(np.max(np.abs(
        (a.rpy - b.rpy + np.pi) % (2 * np.pi) - np.pi), axis=1))
    d_base = np.linalg.norm(a.base_p - b.base_p, axis=1)
    d_thrust = np.max(np.abs(a.thrust - b.thrust), axis=1)

    def ok(s):
        return (s == admm.SOLVED) | (s == admm.SOLVED_INACCURATE)

    return {
        "n_ticks": int(n_ticks),
        "seconds": round(n_ticks * cfg.period_mpc, 3),
        "jets": "lstm+ekf" if use_nn else "direct",
        "alpha_ramp": bool(alpha_ramp),
        "com_div_max_m": round(float(d_com.max()), 5),
        "com_div_mean_m": round(float(d_com.mean()), 5),
        "rpy_div_max_deg": round(float(d_rpy.max()), 4),
        "base_div_max_m": round(float(d_base.max()), 5),
        "thrust_div_max_n": round(float(d_thrust.max()), 4),
        "torch_solved_frac": round(float(ok(a.status).mean()), 4),
        "mujoco_solved_frac": round(float(ok(b.status).mean()), 4),
        "finite": bool(np.isfinite(a.com).all()
                       and np.isfinite(b.com).all()),
    }
