#!/usr/bin/env python
"""Fly the reference trajectory closed-loop through the PyTorch port and
write the evidence (counterpart of tools/fly_full_trajectory.py).

Usage: python tools/fly_full_trajectory_torch.py [seconds=148]
           [--direct-thrust] [--out FLIGHT_torch.json] [--save-mat]
           [--device cuda]

Settles 2 s, configures, then flies ``seconds`` of the 148 s minimum-jerk
reference mission (takeoff on the 35 s alphaGravity ramp, then 3D tracking)
through ``runtime/flight.run_flight`` at batch 1, a Python loop of eager
ticks, and reduces lane 0's telemetry with ``flight_stats``. The record has
the keys of ``FLIGHT_r05.json``; ``"device"`` is the card's name and power
limit as ``nvidia-smi`` prints them, and ``"launches"`` counts each CUDA
kernel's launches over the rollout. Runs on ``cuda`` unless ``--device``
says otherwise. The record goes to ``--out``, never over a committed
``FLIGHT_r*.json``; ``--save-mat`` also writes the telemetry to a
timestamped ``.mat`` (tools/visualize_run.py renders it).
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from common_torch import device_entry, option, positional, writable  # noqa: E402

DEFAULT_OUT = "FLIGHT_torch.json"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv)
    seconds = float(pos[0]) if pos else 148.0
    use_nn = "--direct-thrust" not in argv
    out_path = writable(option(argv, "out", ROOT / DEFAULT_OUT))
    device = option(argv, "device")

    from ironcub_mpc_tpu_torch.core.types import tree_map
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.runtime import flight, telemetry

    loop, pos_traj, alpha_traj = flight.build_flight_loop(use_nn=use_nn,
                                                          device=device)
    dev = loop.kd.device
    print(f"flying {seconds:g} s on {dev} "
          f"({'LSTM+EKF' if use_nn else 'direct thrust'} jets) ...",
          flush=True)
    K.reset_launches()
    tel, info = flight.run_flight(seconds, use_nn=use_nn, loop=loop,
                                  pos_traj=pos_traj, alpha_traj=alpha_traj)
    launches = {"admm_segment": K.admm_segment.launches,
                "woodbury_ns": K.woodbury_ns.launches}
    lane = tree_map(lambda v: v[:, 0].cpu().numpy(), tel)
    stats = flight.flight_stats(lane, loop.cfg.period_mpc,
                                total_mass=loop.kd.model.total_mass)
    record = {"metric": "reference_flight", **info, **stats,
              "device": device_entry(dev), "launches": launches}
    out_path.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    print(f"-> {out_path}")
    if "--save-mat" in argv:
        path = telemetry.save_mat(lane, period=loop.cfg.period_mpc)
        print("telemetry saved ->", path)
    return record


if __name__ == "__main__":
    main()
