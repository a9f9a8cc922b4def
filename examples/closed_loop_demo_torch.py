#!/usr/bin/env python
"""Closed-loop demo of the PyTorch port: iRonCub standing on the ground
under multi-rate MPC (counterpart of examples/closed_loop_demo.py).

Usage: python examples/closed_loop_demo_torch.py [n_ticks] [--nn-jets]
           [--device cpu]

End-to-end equivalent of the reference driver (variable_sampling_mpc.py):
the port's plant at 1 kHz (PD joints + jet forces + ground contacts),
LSTM+EKF thrust estimation, 200 Hz multi-rate MPC, telemetry printout, on
``cuda`` unless ``--device`` says otherwise. Uses the converted reference
trajectories (alphaGravity ramp + minimum-jerk flight).
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from ironcub_mpc_tpu_torch import resolve_device
from ironcub_mpc_tpu_torch.core.config import MPCConfig, RobotConfig, SimConfig
from ironcub_mpc_tpu_torch.dynamics import KinDyn, load_ironcub_model
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.runtime.flight import standing_state
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
from ironcub_mpc_tpu_torch.runtime.trajectory import load_npz
from ironcub_mpc_tpu_torch.sim.jet_lstm import LSTMJetModel
from ironcub_mpc_tpu_torch.sim.plant import Plant


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ticks", nargs="?", type=int, default=200)
    ap.add_argument("--nn-jets", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_ticks = args.n_ticks

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model = load_ironcub_model()
    kd = KinDyn(model, device=dev)
    sim_cfg = SimConfig(use_nn_jet_dynamics=args.nn_jets)
    lstm = (LSTMJetModel(str(ROOT / "data/jet_lstm_weights.npz"), device=dev)
            if args.nn_jets else None)
    plant = Plant(kd, RobotConfig(), sim_cfg, lstm=lstm)
    loop = ClosedLoop(plant, MPCConfig(), admm.ADMMSettings(max_iter=120))

    pos_traj = load_npz(str(ROOT / "data/trajectories/minimum_jerk.npz"))
    alpha_traj = load_npz(str(ROOT / "data/trajectories/alpha_gravity.npz"),
                          des_fps=1.0 / loop.cfg.period_mpc)

    s = standing_state(plant, sim_cfg.initial_position_deg)
    print("settling 1.0 s ...")
    t0 = time.time()
    s = loop.settle(s, 1.0)
    sync()
    print(f"  settled in {time.time()-t0:.1f}s wall; base z = "
          f"{float(s.base_p[0, 2]):.4f}, |qd| = "
          f"{float(s.qd.abs().max()):.4f}")

    problem, carry = loop.configure(
        s, {k: np.asarray(v) for k, v in pos_traj.channels.items()},
        np.asarray(alpha_traj.channels["alphaGravity"])[:, 0])

    t0 = time.time()
    carry, tel = loop.rollout(problem, carry, n_ticks)
    sync()
    wall = time.time() - t0
    print(f"{n_ticks} ticks in {wall:.1f}s wall "
          f"({1e3*wall/n_ticks:.2f} ms/tick)")

    def host(t):
        return t[:, 0].cpu().numpy()

    st = host(tel.solver_status)
    print("solver: solved", int((st == 1).sum()), "/", n_ticks,
          "inaccurate", int((st == 2).sum()), "other", int((st > 2).sum()))
    com, ref = host(tel.com_position), host(tel.com_position_desired)
    thr, T = host(tel.throttle), host(tel.estimated_thrust)
    for k in (0, n_ticks // 2, n_ticks - 1):
        print(f"t={k*0.005:6.3f}s com={np.round(com[k], 3)} "
              f"ref={np.round(ref[k], 3)} thr={np.round(thr[k], 1)} "
              f"T={np.round(T[k], 1)}")
    com_err = np.linalg.norm(com - ref, axis=1)
    print(f"CoM tracking error: mean {com_err.mean()*1000:.1f} mm, "
          f"max {com_err.max()*1000:.1f} mm")
    return tel


if __name__ == "__main__":
    main()
