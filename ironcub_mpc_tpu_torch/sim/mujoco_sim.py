"""Host-MuJoCo simulation path — fidelity cross-check of the port's plant
(counterpart of ``ironcub_mpc_tpu/sim/mujoco_sim.py``).

Re-expression of the reference's ``MujocoSim``
(mujoco_lib/ironcub_mujoco_simulator.py:21-408) against either
(a) a real MJCF asset (``SimConfig.mujoco_model_path``) when the iRonCub
models are installed, or (b) XML generated from the same
:class:`~ironcub_mpc_tpu_torch.dynamics.model.RobotModel` spec the port uses
(:mod:`.mjcf`).

The MPC still consumes a :class:`RobotSnapshot` produced by the port's
kinodynamics on the device of ``kd`` — this class only replaces the *plant*:
step physics with host MuJoCo (float64 on the host), read sensors, apply
joint position targets and jet thrust forces, optionally run the LSTM+EKF
thrust pipeline on the device. Each :meth:`snapshot` packs its six inputs
into one (pinned, on a card) host buffer and copies it to the device once;
each :meth:`step` copies its thrust sequence back once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import RobotConfig, SimConfig
from ..core.types import RobotSnapshot
from ..dynamics.kinodynamics import KinDyn, compute_snapshot
from .ekf import JetEKF
from .jet_lstm import LSTMJetModel


class HostMujocoSim:
    def __init__(self, kd: KinDyn, robot_cfg: RobotConfig | None = None,
                 sim_cfg: SimConfig | None = None,
                 lstm: Optional[LSTMJetModel] = None,
                 mjcf_path: str | None = None,
                 run_visualization: bool = False):
        import mujoco

        self._mujoco = mujoco
        self.kd = kd
        self.device = kd.device
        self.robot_cfg = robot_cfg or RobotConfig()
        self.sim_cfg = sim_cfg or SimConfig()
        if mjcf_path:
            self.model = mujoco.MjModel.from_xml_path(mjcf_path)
        else:
            from .mjcf import mjcf_from_model

            xml = mjcf_from_model(kd.model, floor=True, actuators=True,
                                  timestep=self.sim_cfg.timestep)
            self.model = mujoco.MjModel.from_xml_string(xml)
        self.model.opt.timestep = self.sim_cfg.timestep  # 1 kHz (sim.py:46)
        self.data = mujoco.MjData(self.model)
        self._site_ids = {
            n: mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_SITE, n)
            for n in list(self.robot_cfg.jets_list) + ["l_sole", "r_sole"]
            if mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_SITE, n) >= 0}
        self._dof_adr = []
        self._qpos_adr = []
        for jn in kd.model.joint_names:
            jid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT, jn)
            self._dof_adr.append(self.model.jnt_dofadr[jid])
            self._qpos_adr.append(self.model.jnt_qposadr[jid])
        self._dof_adr = np.asarray(self._dof_adr)
        self._qpos_adr = np.asarray(self._qpos_adr)
        self._jet_body = [
            self.model.site_bodyid[self._site_ids[n]]
            for n in self.robot_cfg.jets_list]

        self.lstm = lstm
        self.ekf = (JetEKF(self.sim_cfg.timestep, dtype=kd.dtype,
                           device=kd.device)
                    if self.sim_cfg.use_nn_jet_dynamics else None)
        opts = dict(dtype=kd.dtype, device=kd.device)
        self._thrust_nn = torch.full((4,), 10.0, **opts)
        self._ekf_state = (self.ekf.init(torch.full((4,), 10.0, **opts))
                           if self.ekf else None)
        # host mirrors of the EKF estimate, refreshed by each step()'s copy
        self._est_thrust = np.full(4, 10.0, np.float32)
        self._est_thrust_dot = np.zeros(4, np.float32)
        self._zero_thrust_dot = torch.zeros((1, 4), **opts)
        self._throttle = np.zeros(4)
        self._thrust_cmd = np.full(4, 10.0)
        self.desired_joint_pos = np.zeros(kd.n)
        self._rng = np.random.default_rng(0)
        # the snapshot's staging buffer: pinned on a card, reused once the
        # previous copy out of it has completed
        n_in = 9 + 3 + 6 + 2 * kd.n + 4
        self._stage = (torch.empty(n_in, dtype=kd.dtype, pin_memory=True)
                       if self.device.type == "cuda" else None)
        self._staged = None
        self.viewer = None
        self._viewer_closed = False
        if run_visualization:
            self.launch_viewer()

    # ------------------------------------------------------------------
    # passive viewer + thrust visualization
    # (ironcub_mujoco_simulator.py:116-120, 398-404)
    # ------------------------------------------------------------------

    def launch_viewer(self) -> bool:
        """Open the passive viewer; returns False (and keeps running
        headless) when no display/GL is available. The display check comes
        first because glfw aborts the process (not an exception) when it
        cannot open one."""
        import os
        import sys
        import warnings

        headless = (sys.platform.startswith("linux")
                    and not os.environ.get("DISPLAY")
                    and not os.environ.get("WAYLAND_DISPLAY"))
        if headless:
            warnings.warn("viewer unavailable (no display); running headless")
            self.viewer = None
            return False
        try:
            import mujoco.viewer

            self.viewer = mujoco.viewer.launch_passive(self.model, self.data)
            return True
        except Exception as e:  # no GL platform
            warnings.warn(f"viewer unavailable ({e}); running headless")
            self.viewer = None
            return False

    def _update_thrust_geoms(self, thrust):
        """Draw one cylinder per jet, scaled by thrust, pointing along the
        exhaust (+z of the jet site — thrust acts along −z). Mirrors the
        reference's thrust visualization (sim.py:398-404)."""
        mujoco = self._mujoco
        scn = self.viewer.user_scn
        scn.ngeom = 0
        for i, name in enumerate(self.robot_cfg.jets_list):
            sid = self._site_ids[name]
            R_site = self.data.site_xmat[sid].reshape(3, 3)
            p = self.data.site_xpos[sid]
            length = 0.002 * max(float(thrust[i]), 0.0)
            geom = scn.geoms[scn.ngeom]
            mujoco.mjv_initGeom(
                geom, mujoco.mjtGeom.mjGEOM_CYLINDER,
                np.array([0.01, 0.01, length / 2 + 1e-6]),
                p + R_site @ np.array([0.0, 0.0, length / 2]),
                R_site.flatten(), np.array([1.0, 0.45, 0.1, 0.6],
                                           np.float32))
            scn.ngeom += 1

    def _viewer_sync(self, thrust):
        if self.viewer is None:
            return
        if not self.viewer.is_running():
            # user closed the window: remember, so is_running() turns False
            # instead of reading None as "headless, run forever"
            self.viewer = None
            self._viewer_closed = True
            return
        self._update_thrust_geoms(thrust)
        self.viewer.sync()

    def is_running(self) -> bool:
        """Driver loop condition (variable_sampling_mpc.py:106): True while
        the viewer is open (or was never opened — headless); False once the
        user closes the viewer window."""
        if self._viewer_closed:
            return False
        return self.viewer is None or self.viewer.is_running()

    # ------------------------------------------------------------------
    # MujocoSim API parity
    # ------------------------------------------------------------------

    def set_state(self, base_R, base_p, q):
        from scipy.spatial.transform import Rotation

        self.data.qpos[:] = 0
        self.data.qvel[:] = 0
        self.data.qpos[0:3] = np.asarray(base_p)
        quat = Rotation.from_matrix(np.asarray(base_R)).as_quat()
        self.data.qpos[3:7] = quat[[3, 0, 1, 2]]
        self.data.qpos[self._qpos_adr] = np.asarray(q)
        self._mujoco.mj_forward(self.model, self.data)

    def set_joint_positions(self, q_des):
        self.desired_joint_pos = np.asarray(q_des)

    def set_throttle(self, throttle):
        self._throttle = np.asarray(throttle)

    def set_thrust(self, thrust):
        self._thrust_cmd = np.asarray(thrust)

    def get_joint_positions(self):
        return self.data.qpos[self._qpos_adr].copy()

    def get_joint_velocities(self):
        return self.data.qvel[self._dof_adr].copy()

    def get_estimated_thrust(self):
        if self.ekf is not None:
            return self._est_thrust.copy()
        return self._thrust_cmd

    def get_estimated_thrust_dot(self):
        if self.ekf is not None:
            return self._est_thrust_dot.copy()
        return np.zeros(4)

    def estimated_thrust_dot(self) -> torch.Tensor:
        """:meth:`get_estimated_thrust_dot` as a [1, 4] tensor on the
        device, with no copy: the EKF state lives there."""
        if self.ekf is not None:
            return self._ekf_state.x[None, :, 1]
        return self._zero_thrust_dot

    def get_base_position(self):
        return self.data.qpos[0:3].copy()

    def get_base_velocity(self):
        # free joint linear velocity is world-frame
        v = self.data.qvel[0:3].copy()
        if self.sim_cfg.simulate_noise:
            v = v + self._rng.normal(0, self.sim_cfg.noise_std_base_vel, 3)
        return v

    def get_base_angular_velocity(self):
        from scipy.spatial.transform import Rotation

        q = self.data.qpos[3:7]
        R = Rotation.from_quat(q[[1, 2, 3, 0]]).as_matrix()
        w = R @ self.data.qvel[3:6]  # free-joint angular vel is body-frame
        if self.sim_cfg.simulate_noise:
            w = w + self._rng.normal(0, self.sim_cfg.noise_std_base_vel, 3)
        return w

    def _apply_thrust_forces(self, thrust):
        """Jet forces along each site's −z axis via xfrc_applied."""
        self.data.xfrc_applied[:] = 0
        for i, name in enumerate(self.robot_cfg.jets_list):
            sid = self._site_ids[name]
            R_site = self.data.site_xmat[sid].reshape(3, 3)
            axis = R_site @ np.array([0.0, 0.0, -1.0])
            f = axis * thrust[i]
            bid = self._jet_body[i]
            p_site = self.data.site_xpos[sid]
            p_body = self.data.xipos[bid]
            self.data.xfrc_applied[bid, 0:3] += f
            self.data.xfrc_applied[bid, 3:6] += np.cross(p_site - p_body, f)

    def _jet_chain(self, n_steps: int):
        """``n_steps`` of LSTM→EKF on the device. The jet pipeline depends
        only on the throttle (constant within a ``step`` call), never on
        MuJoCo state, so the per-1 kHz-substep thrust sequence is computed
        ahead of the physics and stacked on the device. Returns (LSTM
        thrust, EKF state, thrust sequence [n_steps, 4])."""
        dt = float(self.model.opt.timestep)
        throttle = torch.as_tensor(self._throttle, dtype=self.kd.dtype,
                                   device=self.device)
        t_nn, ekf_s = self._thrust_nn, self._ekf_state
        seq = []
        for _ in range(n_steps):
            t, td = self.lstm.step(t_nn, throttle, dt)
            ekf_s = self.ekf.update(ekf_s, throttle, t, td)
            t_nn = t
            seq.append(ekf_s.x[:, 0])
        return t_nn, ekf_s, torch.stack(seq)

    def step(self, n_steps: int = 1):
        """1 kHz loop: LSTM→EKF→thrust, PD targets, mj_step
        (ironcub_mujoco_simulator.py:122-139)."""
        if n_steps < 1:
            return
        if self.ekf is not None:
            t_nn, ekf_s, seq = self._jet_chain(n_steps)
            # one copy back: the thrust sequence and the final Ṫ estimate
            host = torch.cat([seq, ekf_s.x[None, :, 1]]).cpu().numpy()
            thrust_seq = host[:n_steps]
        for k in range(n_steps):
            if self.ekf is not None:
                thrust = thrust_seq[k]
            else:
                thrust = self._thrust_cmd
            self._apply_thrust_forces(thrust)
            self.data.ctrl[:len(self.desired_joint_pos)] = self.desired_joint_pos
            self._mujoco.mj_step(self.model, self.data)
            self._viewer_sync(thrust)
        if self.ekf is not None:
            self._thrust_nn, self._ekf_state = t_nn, ekf_s
            self._est_thrust = host[n_steps - 1].copy()
            self._est_thrust_dot = host[n_steps].copy()

    # ------------------------------------------------------------------

    def snapshot(self) -> RobotSnapshot:
        """Marshal the MuJoCo state into the MPC's one-lane snapshot via the
        port's kinodynamics on the device (update_robot_state equivalent,
        sim.py:318-346): base rotation, position and velocity, joint
        positions and velocities and the estimated thrust go to the device
        in one copy."""
        from scipy.spatial.transform import Rotation

        q = self.data.qpos[3:7]
        R = Rotation.from_quat(q[[1, 2, 3, 0]]).as_matrix()
        base_vel = np.concatenate(
            [self.get_base_velocity(), self.get_base_angular_velocity()])
        parts = (R, self.data.qpos[0:3], base_vel, self.get_joint_positions(),
                 self.get_joint_velocities(), self.get_estimated_thrust())
        if self._stage is None:
            buf = torch.empty(9 + 3 + 6 + 2 * self.kd.n + 4,
                              dtype=self.kd.dtype)
        else:
            if self._staged is not None:
                self._staged.synchronize()
            buf = self._stage
        np.concatenate([np.ravel(a) for a in parts], out=buf.numpy(),
                       casting="same_kind")
        dev = buf.to(self.device, non_blocking=True)
        if self._stage is not None:
            self._staged = torch.cuda.Event()
            self._staged.record()
        n = self.kd.n
        sizes = (9, 3, 6, n, n, 4)
        R_t, p_t, v_t, q_t, qd_t, T_t = torch.split(dev, sizes)
        return compute_snapshot(
            self.kd, self.robot_cfg.jets_list, R_t.reshape(1, 3, 3),
            p_t[None], v_t[None], q_t[None], qd_t[None], T_t[None])
