#!/usr/bin/env python
"""Capture the port's host-in-the-loop real-time record (RT_torch_*.json):
examples/realtime_driver_torch.py's loop — native absolute-deadline pacer,
the MPC tick on the card with one host wait a tick, the SPSC telemetry ring
— for n_ticks at the reference's 5 ms period (reference contract:
variable_sampling_mpc.py:110-123).

Usage: python3 tools/capture_rt_torch.py [n_ticks=2500]
           [out=RT_torch_h100.json] [--device cuda|cpu]

The record names the device (on a card: its name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and the scheduling policy (under SCHED_FIFO: ``chrt -f 10 python3
tools/capture_rt_torch.py``). The tool refuses to write over any existing
file, so a committed record (RT_r04.json, RT_r05.json) is never replaced.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tools"))

from common_torch import card_line  # noqa: E402

POLICIES = {os.SCHED_OTHER: "SCHED_OTHER", os.SCHED_FIFO: "SCHED_FIFO",
            os.SCHED_RR: "SCHED_RR"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ticks", nargs="?", type=int, default=2500)
    ap.add_argument("out", nargs="?", default="RT_torch_h100.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if not out.is_absolute():
        out = ROOT / out
    if out.exists():
        raise SystemExit(f"{out} exists; name a new record")

    import realtime_driver_torch

    stats = realtime_driver_torch.run(n_ticks=args.n_ticks, period_s=0.005,
                                      device=args.device, verbose=True)
    stats["period_ms"] = 5.0
    stats["device_arg"] = args.device
    if args.device != "cpu":
        stats["card"] = card_line()
    stats["overrun_frac"] = round(stats["overruns"] / args.n_ticks, 5)
    policy = os.sched_getscheduler(0)
    stats["sched_policy"] = POLICIES.get(policy, str(policy))
    out.write_text(json.dumps(stats, indent=1) + "\n")
    print(f"wrote {out}")
    return stats


if __name__ == "__main__":
    main()
