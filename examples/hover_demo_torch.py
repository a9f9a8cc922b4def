#!/usr/bin/env python
"""Hover-regulation demo of the PyTorch port: drive the multi-rate MPC
open-loop (counterpart of examples/hover_demo.py).

Usage:  python examples/hover_demo_torch.py [n_ticks] [--device cpu]

Configures the MPC on a synthetic hover state of an iRonCub-like robot
(40 kg, 4 jets) and runs the 200 Hz tick repeatedly, printing the multi-rate
command stream: joint references update every 5 ms, throttle only at 10 Hz.
This is BASELINE config 1 ("hover regulation") without the physics plant —
the measured state is held at hover; the controller should keep thrust at
m·g/4 ≈ 98.1 N per jet and leave the posture alone. Runs on ``cuda``
unless ``--device`` says otherwise.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ironcub_mpc_tpu_torch import resolve_device
from ironcub_mpc_tpu_torch.core.config import (MPCConfig, RobotConfig,
                                               joint_selector)
from ironcub_mpc_tpu_torch.core.types import RobotSnapshot
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc


def hover_snapshot(mass=40.0, device=None) -> RobotSnapshot:
    """Synthetic upright hover state of one lane (stand-in for the dynamics
    layer), the values of examples/hover_demo.py."""
    thrust = mass * 9.81 / 4.0
    axes = np.tile([0.0, 0.0, 1.0], (4, 1))
    arms = np.array([[0.25, 0.35, -0.05], [0.25, -0.35, -0.05],
                     [-0.08, 0.12, 0.10], [-0.08, -0.12, 0.10]])
    amom = np.zeros((6, 4))
    amom[:3] = axes.T
    for i in range(4):
        amom[3:, i] = np.cross(arms[i], axes[i])
    rng = np.random.default_rng(0)
    dev = resolve_device(device)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)[None]

    J = 23
    return RobotSnapshot(
        w_R_b=f(np.eye(3)), base_pos=f([0, 0, 0.5]),
        base_ang_vel_world=f(np.zeros(3)), com_pos=f([0, 0, 0.6]),
        total_mass=f(mass), momentum_body=f(np.zeros(6)),
        inertia_locked=f(np.diag([2.1, 1.9, 0.8])),
        amom_jets_body=f(amom), jet_axes_world=f(axes), jet_arms_world=f(arms),
        jac_jets_lin_joints=f(rng.normal(0, 0.02, (4, 3, J))),
        jac_com_joints=f(rng.normal(0, 0.01, (3, J))),
        rel_jac_lin=f(rng.normal(0, 0.02, (4, 3, J))),
        rel_jac_ang=f(rng.normal(0, 0.02, (4, 3, J))),
        joint_pos=f(np.zeros(J)), jet_thrusts=f(np.full(4, thrust)),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ticks", nargs="?", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = MPCConfig()
    sched = build_schedule(cfg)
    sel = joint_selector(RobotConfig(), cfg)
    settings = admm.ADMMSettings(max_iter=150)
    snap = hover_snapshot(device=dev)

    channels = {k: np.zeros((30, 3)) for k in
                ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
    alpha = np.ones(600)  # full gravity compensation

    print(f"QP: {cfg.n_var} vars, {cfg.n_constraints} constraints, "
          f"horizon {cfg.n_iter} knots / {sched.total_span:.2f} s")
    problem, carry = vs_mpc.configure(cfg, sched, sel, snap, channels, alpha,
                                      settings, device=dev)
    est_td = torch.zeros((1, 4), device=dev)
    print(f"{'tick':>5} {'status':>6} {'thrust_des[0] N':>15} "
          f"{'throttle[0] %':>13} {'max|dq| rad':>12}")
    prev_joints = carry.joints_pos_ref[0].cpu().numpy()
    statuses = []
    for k in range(args.n_ticks):
        carry, out = vs_mpc.mpc_tick(cfg, sched, sel, settings, problem,
                                     carry, snap, est_td)
        joints = out.joints_pos_ref[0].cpu().numpy()
        statuses.append(int(out.status[0]))
        if k < 3 or (k + 1) % 5 == 0 or k in (18, 19, 20):
            print(f"{k:>5} {statuses[-1]:>6} "
                  f"{float(out.thrust_des[0, 0]):>15.2f} "
                  f"{float(out.throttle[0, 0]):>13.2f} "
                  f"{np.max(np.abs(joints - prev_joints)):>12.5f}")
        prev_joints = joints
    print("done:", args.n_ticks, "ticks")
    return statuses


if __name__ == "__main__":
    main()
