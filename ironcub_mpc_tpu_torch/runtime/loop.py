"""Closed-loop runtime: 200 Hz MPC over the 1 kHz plant (counterpart of
``ironcub_mpc_tpu/runtime/loop.py``).

Settle on the ground under PD + idle thrust, configure the MPC, then loop
{read sensors → update+solve → apply commands → 5 plant substeps} while
accumulating telemetry. Every state tensor carries a leading batch dimension
B (one lane per scenario), so a robustness sweep is one batched rollout. The
MPC problem is shared by every lane: it is configured from lane 0, so the
lanes must share the state they are configured from (they may differ in
their perturbation fields, e.g. ``wind_force``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import MPCConfig, joint_selector
from ..core.types import (DebugInfo, MPCCarry, RobotSnapshot, expand_lanes,
                          tree_map)
from ..dynamics.kinodynamics import compute_snapshot
from ..horizon.schedule import build_schedule
from ..ops import admm
from ..ops.so3 import matrix_to_rpy
from ..qp import mpc as vs_mpc
from ..sim.plant import SOLE_FRAMES, Plant, PlantState


class LoopCarry(NamedTuple):
    plant: PlantState
    mpc: MPCCarry
    base_lin_vel_filt: torch.Tensor  # telemetry low-pass
    base_ang_vel_filt: torch.Tensor


class TickTelemetry(NamedTuple):
    """Per-tick channels, named as the saved .mat arrays of a flight."""

    com_position: torch.Tensor
    com_position_desired: torch.Tensor
    base_orientation_desired: torch.Tensor
    base_position: torch.Tensor
    base_orientation: torch.Tensor
    base_lin_vel: torch.Tensor
    base_ang_vel: torch.Tensor
    base_lin_vel_filtered: torch.Tensor
    base_ang_vel_filtered: torch.Tensor
    joints_pos_meas: torch.Tensor
    joints_vel_meas: torch.Tensor
    joints_pos_ref: torch.Tensor
    linear_momentum: torch.Tensor
    angular_momentum: torch.Tensor
    momentum_reference: torch.Tensor
    estimated_thrust: torch.Tensor
    estimated_thrust_dot: torch.Tensor
    thrust_desired: torch.Tensor
    thrust_desired_dot: torch.Tensor
    alpha_gravity: torch.Tensor
    throttle: torch.Tensor
    solver_status: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    # wrench aggregation channels
    zmp: torch.Tensor
    on_ground: torch.Tensor
    ext_wrench_sum: torch.Tensor
    # [] bool: carried-inverse recovery guard re-factorised this tick
    guard_fired: torch.Tensor = None
    # per-block QP introspection of debug-log mode (None when it is off)
    debug: DebugInfo = None


class ClosedLoop:
    """Binds a plant, a kinodynamics model and the MPC into one system."""

    def __init__(self, plant: Plant, mpc_cfg: MPCConfig | None = None,
                 settings: admm.ADMMSettings | None = None):
        self.plant = plant
        self.kd = plant.kd
        self.robot_cfg = plant.robot_cfg
        self.cfg = mpc_cfg or MPCConfig()
        self.sched = build_schedule(self.cfg)
        self.sel = joint_selector(self.robot_cfg, self.cfg)
        self.settings = settings or admm.ADMMSettings(max_iter=150)
        self.n_substeps = round(self.cfg.period_mpc / plant.dt)
        # low-pass alpha of the telemetry filter
        self.alpha_lp = self.cfg.period_mpc / (2 * 3.14 * 3 * self.cfg.period_mpc)

    # ------------------------------------------------------------------

    def snapshot(self, s: PlantState) -> Tuple[RobotSnapshot, PlantState]:
        """The measured robot state from plant sensors (raw velocities feed
        the kinodynamics; the low-pass is telemetry-only). Sole contact
        wrenches feed the snapshot's ZMP/ground-contact aggregation."""
        lin, ang, s = self.plant.measured_base_velocity(s)
        base_vel = torch.cat([lin, ang], dim=-1)
        snap = compute_snapshot(
            self.kd, self.robot_cfg.jets_list, s.base_R, s.base_p, base_vel,
            s.q, s.qd, self.plant.applied_thrust(s),
            ext_wrench_frames=SOLE_FRAMES,
            ext_wrenches_body=self.plant.sole_wrenches(s),
            ground_threshold=self.robot_cfg.threshold_normal_force_on_ground)
        return snap, s

    def settle(self, s: PlantState, seconds: float = 2.0) -> PlantState:
        """Stand under PD with idle thrust."""
        n = int(round(seconds / self.plant.dt))
        return self.plant.step(s, n)

    def configure(self, s: PlantState, traj_channels, alpha_traj):
        """(problem, carry) from the plant state ``s`` of B lanes: the
        problem and the one-lane MPC carry come from lane 0 and the carry is
        repeated for every lane."""
        snap, s = self.snapshot(s)
        B = s.q.shape[0]
        snap0 = RobotSnapshot(*(None if t is None else t[:1] for t in snap))
        problem, mpc_carry = vs_mpc.configure(
            self.cfg, self.sched, self.sel, snap0, traj_channels, alpha_traj,
            self.settings, est_thrust_dot=s.ekf.x[:1, :, 1],
            initial_throttle=s.throttle[:1], device=self.kd.device,
            dtype=self.kd.dtype)
        zeros = torch.zeros((B, 3), dtype=self.kd.dtype, device=self.kd.device)
        carry = LoopCarry(plant=s, mpc=expand_lanes(mpc_carry, B),
                          base_lin_vel_filt=zeros,
                          base_ang_vel_filt=zeros.clone())
        return problem, carry

    # ------------------------------------------------------------------

    def tick(self, problem, carry: LoopCarry,
             settings: admm.ADMMSettings | None = None
             ) -> Tuple[LoopCarry, TickTelemetry]:
        """One 5 ms control tick + 5 plant substeps for every lane.

        ``settings`` overrides the loop's solver settings for this tick (a
        failure-recovery pass re-runs a bad tick with a fresh factorisation
        and boosted iterations)."""
        s = carry.plant
        snap, s = self.snapshot(s)
        est_td = s.ekf.x[..., 1]
        mpc_carry, out = vs_mpc.mpc_tick(
            self.cfg, self.sched, self.sel, settings or self.settings,
            problem, carry.mpc, snap, est_td)

        # apply commands
        if not self.plant.sim_cfg.use_nn_jet_dynamics:
            s = self.plant.set_thrust(s, out.thrust_des)
        s = self.plant.set_joint_positions(s, out.joints_pos_ref)
        s = self.plant.set_throttle(s, out.throttle)

        # telemetry low-pass on base velocities
        lin, ang = s.base_v[:, 0:3], s.base_v[:, 3:6]
        a = self.alpha_lp
        lp_lin = a * lin + (1 - a) * carry.base_lin_vel_filt
        lp_ang = a * ang + (1 - a) * carry.base_ang_vel_filt

        tel = TickTelemetry(
            com_position=snap.com_pos,
            com_position_desired=out.pos_com_ref,
            base_orientation_desired=out.rpy_ref,
            base_position=s.base_p,
            base_orientation=matrix_to_rpy(s.base_R),
            base_lin_vel=lin, base_ang_vel=ang,
            base_lin_vel_filtered=lp_lin, base_ang_vel_filtered=lp_ang,
            joints_pos_meas=s.q, joints_vel_meas=s.qd,
            joints_pos_ref=out.joints_pos_ref,
            linear_momentum=snap.momentum_body[:, :3],
            angular_momentum=snap.momentum_body[:, 3:],
            momentum_reference=out.mom_ref,
            estimated_thrust=self.plant.applied_thrust(s),
            estimated_thrust_dot=est_td,
            thrust_desired=out.thrust_des,
            thrust_desired_dot=out.thrust_dot_des,
            alpha_gravity=out.alpha_gravity,
            throttle=out.throttle,
            solver_status=out.status,
            pri_res=out.pri_res,
            dua_res=out.dua_res,
            guard_fired=out.guard_fired,
            zmp=snap.zmp,
            on_ground=snap.on_ground,
            ext_wrench_sum=snap.ext_wrench_sum,
            debug=out.debug,
        )

        s = self.plant.step(s, self.n_substeps)
        return LoopCarry(plant=s, mpc=mpc_carry,
                         base_lin_vel_filt=lp_lin, base_ang_vel_filt=lp_ang), tel

    def rollout(self, problem, carry: LoopCarry, n_ticks: int):
        """``n_ticks`` ticks in a Python loop. Each tick's telemetry (the
        debug-log triples included) is written into tensors [n_ticks, B, ...]
        on the device, allocated once from the first tick's shapes; nothing
        is read back on the host."""
        bufs = None
        for t in range(n_ticks):
            carry, tel = self.tick(problem, carry)
            if bufs is None:
                bufs = tree_map(lambda v: torch.empty(
                    (n_ticks,) + tuple(v.shape), dtype=v.dtype,
                    device=v.device), tel)
            tree_map(lambda buf, v: buf.__setitem__(t, v), bufs, tel)
        if bufs is None:
            raise ValueError("rollout needs n_ticks >= 1")
        return carry, bufs
