#!/usr/bin/env python
"""Model-mismatch robustness sweep of the PyTorch port → JSON record.

The counterpart of tools/run_mismatch_sweep.py, with its arguments, levels
(segment-mass error / jet placement error: 0 / 0, 5 % / 0.5 cm, 10 % / 1 cm,
20 % / 2 cm), seeds (``int(m_std * 1000) + 11``), chunk of 250 ticks and
JSON keys: the controller linearises against the nominal calibrated Mk3
model while each scenario's plant flies perturbed masses, inertias and jet
placements, under a fixed gust (--wind, default 5 N std). Scenarios branch
airborne as in tools/run_robustness_sweep_torch.py, whose docstring says
what the fast-forward costs and why the sweep keeps the CUDA kernels.
``"device"`` holds the card's name and power limit.

Usage: python tools/run_mismatch_sweep_torch.py [n_per_level=256]
           [seconds=10] [--skip 22] [--out FILE.json] [--ckpt DIR]
           [--wind N] [--quick] [--no-recover] [--device cuda]

--quick runs only the matched and ±10 %/1 cm levels; recovery is on unless
--no-recover. The record is printed and written only to --out, never over a
committed ``MISMATCH*_r*.json``.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from run_robustness_sweep_torch import (  # noqa: E402
    CHUNK_TICKS, branch_airborne, device_entry, level_stats, out_path,
    parse_args, solver_entry)

LEVELS = ((0.0, 0.0), (0.05, 0.005), (0.10, 0.01), (0.20, 0.02))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_scen, seconds, opts = parse_args(argv)
    out = out_path(opts)
    ckpt_root = Path(opts["ckpt"]) if "ckpt" in opts else None
    skip_s = float(opts.get("skip", 22.0))
    wind_std = float(opts.get("wind", 5.0))

    from ironcub_mpc_tpu_torch.parallel import (
        ScenarioConfig, make_batched_carry, make_mesh, multihost_init,
        run_sweep)

    multihost_init()
    mesh = make_mesh(device=opts.get("device"))
    loop, problem, carry = branch_airborne(skip_s, mesh.device)

    n_dev = mesh.world_size
    n_ticks = int(round(seconds / loop.cfg.period_mpc))
    n_per = max(n_dev, n_scen // n_dev * n_dev)
    levels = [LEVELS[0], LEVELS[2]] if "quick" in opts else list(LEVELS)
    recover = "no-recover" not in opts
    levels_out = []
    t0 = time.time()
    for m_std, j_std in levels:
        scen = ScenarioConfig(wind_force_std=wind_std, com_err_fail=1.0,
                              mass_scale_std=m_std, jet_pos_std_m=j_std)
        batched = make_batched_carry(carry, n_per, scen,
                                     seed=int(m_std * 1000) + 11)
        print(f"sweeping {n_per} scenarios x {seconds:.0f} s at mass "
              f"±{m_std:.0%} / jets ±{j_std * 100:.1f} cm "
              f"[{mesh.device}] ...", flush=True)
        ck = str(ckpt_root / f"mm_{int(m_std * 100)}") if ckpt_root else None
        res = run_sweep(loop, problem, batched, n_ticks, mesh=mesh,
                        scen=scen, chunk_ticks=CHUNK_TICKS,
                        checkpoint_dir=ck, recover=recover)
        stats = level_stats(res, n_per)
        stats.pop("n_solver_bad")
        levels_out.append({
            "mass_scale_std": m_std, "jet_pos_std_m": j_std, **stats,
            "n_ticks_retried": int(res.n_ticks_retried),
            "n_ticks_recovered": int(res.n_ticks_recovered)})
    wall = time.time() - t0

    record = {
        "metric": "model_mismatch_sweep",
        "controller_model": "nominal calibrated Mk3 "
                            "(data/ironcub_mk3_calibrated.urdf)",
        "plant_model": "per-scenario perturbed masses/inertias + jet "
                       "placements",
        "wind_force_std_n": wind_std,
        "n_scenarios_total": n_per * len(levels),
        "seconds": seconds,
        "n_ticks": n_ticks,
        "branch_airborne_at_s": skip_s,
        "com_err_fail_m": 1.0,
        "levels": levels_out,
        "wall_s": round(wall, 1),
        "solver": solver_entry(loop.settings),
        "device": device_entry(mesh.device),
        "n_devices": n_dev,
    }
    if mesh.rank == 0:
        print(json.dumps(record))
        if out:
            out.write_text(json.dumps(record, indent=1) + "\n")
            print(f"-> {out}")
    return record


if __name__ == "__main__":
    main()
