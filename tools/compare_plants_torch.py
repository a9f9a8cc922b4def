#!/usr/bin/env python
"""Cross-engine plant divergence of the PyTorch port: its plant against
host MuJoCo, same controller (counterpart of tools/compare_plants.py).

Usage: python3 tools/compare_plants_torch.py [n_ticks=400] [--direct-thrust]
           [--no-ramp] [--device cuda|cpu] [--out PLANTDIV.json]

Prints (and optionally writes) the divergence report of
ironcub_mpc_tpu_torch.sim.validate.compare_plants, with the device it ran
on added — the evidence that the port's plant tracks MuJoCo's physics under
closed-loop control. Needs the ``mujoco`` package.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ticks", nargs="?", type=int, default=400)
    ap.add_argument("--direct-thrust", action="store_true")
    ap.add_argument("--no-ramp", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from ironcub_mpc_tpu_torch.sim.validate import compare_plants

    report = compare_plants(n_ticks=args.n_ticks,
                            use_nn=not args.direct_thrust,
                            alpha_ramp=not args.no_ramp, device=args.device)
    report["device"] = (torch.cuda.get_device_name(0)
                        if args.device != "cpu" else "cpu")
    print(json.dumps(report))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
        print(f"-> {args.out}")
    return report


if __name__ == "__main__":
    main()
