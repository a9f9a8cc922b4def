#!/usr/bin/env python
"""Full flight demo of the PyTorch port: takeoff + trajectory tracking on
the reference schedule (counterpart of examples/flight_demo.py).

Usage: python examples/flight_demo_torch.py [seconds] [--direct-thrust]
           [--save-mat [PATH]] [--device cpu]

Runs the complete closed loop (the port's plant + LSTM/EKF jets +
multi-rate MPC) against the *converted reference data*: the 35 s
alphaGravity ramp and the 148 s minimum-jerk flight trajectory — BASELINE
config 3 — on ``cuda`` unless ``--device`` says otherwise. ``--save-mat``
writes the telemetry under the reference's channel names
(runtime.telemetry.save_mat; timestamped unless PATH is given), which
tools/visualize_run.py renders.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seconds", nargs="?", type=float, default=30.0)
    ap.add_argument("--direct-thrust", action="store_true")
    ap.add_argument("--save-mat", nargs="?", const="", default=None,
                    metavar="PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seconds, use_nn = args.seconds, not args.direct_thrust

    from ironcub_mpc_tpu_torch.core.types import tree_map
    from ironcub_mpc_tpu_torch.runtime import flight, telemetry

    loop, pos_traj, alpha_traj = flight.build_flight_loop(
        use_nn=use_nn, device=args.device)
    model = loop.kd.model
    n_ticks = int(round(seconds / loop.cfg.period_mpc))
    print(f"jets: {'LSTM+EKF' if use_nn else 'direct thrust'}; settling 2 s, "
          f"then flying {seconds:.0f} s = {n_ticks} ticks on "
          f"{loop.kd.device} ...")
    tel, info = flight.run_flight(seconds, use_nn=use_nn, loop=loop,
                                  pos_traj=pos_traj, alpha_traj=alpha_traj)
    print(f"rollout: {info['rollout_wall_s']:.1f}s wall "
          f"({info['ms_per_tick']:.2f} ms/tick, "
          f"{info['realtime_factor']:.1f}x realtime) on {info['device']}")

    tel = tree_map(lambda v: v[:, 0], tel)         # the one lane
    st = tel.solver_status.cpu().numpy()
    print(f"solver: solved {int((st==1).sum())}/{n_ticks}, "
          f"inaccurate {int((st==2).sum())}, other {int((st>2).sum())}")
    com = tel.com_position.cpu().numpy()
    ref = tel.com_position_desired.cpu().numpy()
    err = np.linalg.norm(com - ref, axis=1)
    thr = tel.throttle.cpu().numpy()
    T = tel.estimated_thrust.cpu().numpy()
    alpha = tel.alpha_gravity.cpu().numpy()
    print(f"{'t[s]':>6} {'alpha':>6} {'com z':>7} {'ref z':>7} {'err[mm]':>8} "
          f"{'thr%':>6} {'T[N]':>7}")
    for sec in range(0, int(seconds) + 1, max(1, int(seconds) // 12)):
        k = min(int(sec / loop.cfg.period_mpc), n_ticks - 1)
        print(f"{sec:>6} {alpha[k]:>6.2f} {com[k,2]:>7.3f} {ref[k,2]:>7.3f} "
              f"{1e3*err[k]:>8.1f} {thr[k,0]:>6.1f} {T[k,0]:>7.1f}")
    half = n_ticks // 2
    print(f"tracking err: mean {1e3*err.mean():.1f} mm | "
          f"second half mean {1e3*err[half:].mean():.1f} mm | "
          f"max {1e3*err.max():.1f} mm")
    airborne = T.sum(axis=1) > 0.9 * model.total_mass * 9.81
    if airborne.any():
        print(f"airborne (thrust > 0.9 m g) from t="
              f"{airborne.argmax()*loop.cfg.period_mpc:.1f}s")
    path = None
    if args.save_mat is not None:
        path = telemetry.save_mat(tel, args.save_mat or None,
                                  period=loop.cfg.period_mpc)
        print("telemetry saved ->", path)
    return tel, info, path


if __name__ == "__main__":
    main()
