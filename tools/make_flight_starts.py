#!/usr/bin/env python
"""Fly the mission once on the port and save the states the benchmark's
flight cell starts its passes from.

The flight loop of ``runtime/flight.py`` (``build_flight_loop`` at its
defaults, which ``mpcbench/configs/mk3_flight.json`` states) settles the
robot on the ground, configures the MPC on the settled state and flies the
148 s mission's first ticks. Three files, each a ``.npz``:

- ``flight_start.npz``: the settled plant state ``configure`` runs from,
  under ``plant.<field>`` (``runtime/checkpoint.py``'s flat names);
- ``flight_takeoff.npz``, ``flight_airborne.npz``: the closed loop's whole
  state (``LoopCarry``: the plant state, the controller's carry with its
  warm start and carried K^-1, the telemetry filter) before mission ticks
  2700 (13.5 s) and 4400 (22 s), under ``carry.<field>``.

Every tensor keeps its lane dimension (batch 1) and dtype. Each file also
carries ``meta_commit`` (the git commit of the tree that flew, ``+dirty``
where it had uncommitted changes), ``meta_device``, ``meta_dtype`` and
``meta_tick`` (the mission tick it holds, 0 for the settled state). The
settle and the 4400 ticks take ~4 min on a CPU core.

Usage: python tools/make_flight_starts.py [--device cuda] [--out DIR]

``DIR`` defaults to ``mpcbench/streams``; an existing file is replaced.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

from common_torch import option, writable  # noqa: E402

STARTS = {"flight_takeoff": 2700, "flight_airborne": 4400}


def commit() -> str:
    """The checkout's commit, ``+dirty`` where the tree differs from it."""
    def git(*args):
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    try:
        head = git("rev-parse", "HEAD")
        return head + ("+dirty" if git("status", "--porcelain",
                                       "--untracked-files=no") else "")
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def save(path: Path, flat: dict, meta: dict) -> None:
    arrays = {k: v.detach().cpu().numpy() for k, v in flat.items()}
    arrays.update({f"meta_{k}": np.asarray(v) for k, v in meta.items()})
    np.savez_compressed(path, **arrays)
    print(f"{path} ({path.stat().st_size / 1e3:.1f} kB)", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    out = writable(option(argv, "out") or ROOT / "mpcbench" / "streams")
    out.mkdir(parents=True, exist_ok=True)

    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.runtime import checkpoint, flight

    loop, pos_traj, alpha_traj = flight.build_flight_loop(
        device=option(argv, "device"))
    dev = loop.kd.device
    meta = dict(commit=commit(), device=str(dev),
                dtype=str(loop.kd.dtype).replace("torch.", ""))
    s = flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg)
    s = loop.settle(s, 2.0)
    save(out / "flight_start.npz", checkpoint.flatten("plant", s),
         dict(meta, tick=0))
    problem, carry = loop.configure(s, *flight.mission_inputs(pos_traj,
                                                              alpha_traj))
    last = max(STARTS.values())
    for k in range(last + 1):
        for name, tick in STARTS.items():
            if k == tick:
                save(out / f"{name}.npz", checkpoint.flatten("carry", carry),
                     dict(meta, tick=tick))
        if k == last:
            break
        carry, tel = loop.tick(problem, carry)
        status = int(tel.solver_status[0])
        if status not in (admm.SOLVED, admm.SOLVED_INACCURATE):
            raise SystemExit(f"tick {k}: solver status {status}")
        if k % 500 == 0:
            print(f"tick {k}: base z {float(carry.plant.base_p[0, 2]):.3f} m",
                  flush=True)


if __name__ == "__main__":
    main()
