#!/usr/bin/env python
"""Monte-Carlo robustness sweep of the PyTorch port → JSON record.

The counterpart of tools/run_robustness_sweep.py, with its arguments, wind
levels (5, 10, 20 N), seeds (``int(w_std * 100)``, ``+ 7919`` for the
resample), chunk of 250 ticks and JSON keys: perturbed closed-loop rollouts
(constant wind gusts, multiplicative thrust-model mismatch, initial
base-velocity and posture noise) as one batched rollout
(ironcub_mpc_tpu_torch/parallel/monte_carlo.py), with the batch-wide
carried-inverse guard, failure recovery and one resample of failed
scenarios. ``"device"`` holds the card's name and power limit as
``nvidia-smi`` prints them.

The sweep branches AIRBORNE: the nominal mission is fast-forwarded past
takeoff (--skip, default 22 s) at batch 1, then every scenario perturbs that
carry and flies on (see the JAX tool for why). The fast-forward is 4400
batch-1 ticks of the eager closed loop, 55–130 ms a tick on an H100
(PERF.md §5): 4 to 10 minutes before the first level.

Kernels: the JAX tool switches its Pallas kernels off for batched sweeps (on
a TPU the batched-GEMM path was faster). Here the sweep keeps
``kernel_mode="auto"``: on the H100 the plain PyTorch twins are 20–40×
slower than the CUDA kernels at batch 256 (PERF.md §6).

Usage: python tools/run_robustness_sweep_torch.py [n_scenarios=256]
           [seconds=10] [--skip 22] [--out FILE.json] [--ckpt DIR]
           [--ns-skip] [--no-recover] [--no-resample] [--device cuda]

Runs on ``cuda`` unless --device says otherwise; with ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set, one process a card
(parallel/mesh.py). The record is printed and written only to --out, never
over a committed ``SWEEP_r*.json`` or ``MISMATCH*_r*.json``. With --ckpt
each level's sweep state is checkpointed after every chunk; re-running the
same command resumes interrupted levels.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from common_torch import device_entry, writable  # noqa: E402

WIND_LEVELS = (5.0, 10.0, 20.0)
CHUNK_TICKS = 250
RESAMPLE_SEED = 7919


def parse_args(argv, n_default=256):
    """(positional [n, seconds], {option: value}) of a sweep tool's command
    line."""
    pos = [a for i, a in enumerate(argv) if not a.startswith("--")
           and (i == 0 or argv[i - 1] not in ("--out", "--ckpt", "--skip",
                                               "--wind", "--device"))]
    opts = {}
    for i, a in enumerate(argv):
        if a in ("--out", "--ckpt", "--skip", "--wind", "--device") \
                and i + 1 < len(argv):
            opts[a[2:]] = argv[i + 1]
        elif a.startswith("--"):
            opts[a[2:]] = True
    n = int(pos[0]) if pos else n_default
    seconds = float(pos[1]) if len(pos) > 1 else 10.0
    return n, seconds, opts


def out_path(opts):
    """--out as a path; refuses the committed sweep records."""
    return writable(opts["out"]) if "out" in opts else None


def branch_airborne(skip_s, device):
    """The flight loop, its problem and the one-lane carry of the nominal
    mission ``skip_s`` seconds in (2 s settle, configure, fast-forward),
    then the loop switched to batch-wide decisions for the sweep."""
    from ironcub_mpc_tpu_torch.runtime import flight

    loop, pos_traj, alpha_traj = flight.build_flight_loop(use_nn=True,
                                                          device=device)
    s = flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg)
    s = loop.settle(s, 2.0)
    problem, carry = loop.configure(
        s, *flight.mission_inputs(pos_traj, alpha_traj))
    if skip_s > 0:
        n_skip = int(round(skip_s / loop.cfg.period_mpc))
        print(f"fast-forwarding nominal mission {skip_s:.0f} s "
              f"({n_skip} ticks) to branch airborne ...", flush=True)
        for _ in range(n_skip):
            carry, _ = loop.tick(problem, carry)
    # applied only now: the fast-forward runs one lane
    loop.settings = dataclasses.replace(loop.settings, batch_guard=True)
    return loop, problem, carry


def solver_entry(settings):
    return {"max_iter": settings.max_iter,
            "term_check_every": settings.term_check_every,
            "eps_abs": settings.eps_abs, "eps_rel": settings.eps_rel,
            "ns_skip_tol": settings.ns_skip_tol,
            "rho_update_iters": list(settings.rho_update_iters)}


def level_stats(res, n_per):
    from ironcub_mpc_tpu_torch.parallel import STATUS_COLS

    return {
        "n_scenarios": int(res.n_scenarios),
        "n_failed": int(res.n_failed),
        "n_solver_bad": int(res.n_solver_bad),
        "success_rate": round(1.0 - int(res.n_failed) / n_per, 4),
        "solved_frac": round(float(res.solved_frac), 6),
        "mean_max_com_err_m": round(float(res.mean_com_err), 4),
        "worst_healthy_com_err_m": round(float(res.max_com_err), 4),
        "status_counts": {k: int(v) for k, v in
                          zip(STATUS_COLS, res.status_counts.tolist())},
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_scen, seconds, opts = parse_args(argv)
    out = out_path(opts)
    ckpt_root = Path(opts["ckpt"]) if "ckpt" in opts else None
    skip_s = float(opts.get("skip", 22.0))

    from ironcub_mpc_tpu_torch.parallel import (
        ScenarioConfig, make_batched_carry, make_mesh, multihost_init,
        run_sweep)

    multihost_init()
    mesh = make_mesh(device=opts.get("device"))
    loop, problem, carry = branch_airborne(skip_s, mesh.device)
    # --ns-skip: the probe-gated refresh skip (off by default, as in the
    # JAX tool, so records stay comparable)
    loop.settings = dataclasses.replace(
        loop.settings, ns_skip_tol=0.02 if "ns-skip" in opts else 0.0)

    n_dev = mesh.world_size
    n_ticks = int(round(seconds / loop.cfg.period_mpc))
    recover = "no-recover" not in opts
    resample = "no-resample" not in opts
    n_per = max(n_dev, n_scen // len(WIND_LEVELS) // n_dev * n_dev)
    levels_out = []
    t0 = time.time()
    for w_std in WIND_LEVELS:
        scen = ScenarioConfig(wind_force_std=w_std, com_err_fail=1.0)
        batched = make_batched_carry(carry, n_per, scen,
                                     seed=int(w_std * 100))
        print(f"sweeping {n_per} scenarios x {seconds:.0f} s at wind std "
              f"{w_std:.0f} N on {n_dev} device(s) [{mesh.device}] ...",
              flush=True)
        ck = str(ckpt_root / f"wind_{int(w_std)}") if ckpt_root else None
        res = run_sweep(loop, problem, batched, n_ticks, mesh=mesh,
                        scen=scen, chunk_ticks=CHUNK_TICKS,
                        checkpoint_dir=ck, recover=recover)
        level = {"wind_force_std_n": w_std, **level_stats(res, n_per),
                 "recovery_on": recover,
                 "n_ticks_retried": int(res.n_ticks_retried),
                 "n_ticks_recovered": int(res.n_ticks_recovered)}
        if resample and int(res.n_failed) > 0:
            n_re = max(n_dev, -(-int(res.n_failed) // n_dev) * n_dev)
            re_batched = make_batched_carry(
                carry, n_re, scen, seed=int(w_std * 100) + RESAMPLE_SEED)
            re_res = run_sweep(loop, problem, re_batched, n_ticks, mesh=mesh,
                               scen=scen, chunk_ticks=CHUNK_TICKS,
                               recover=recover)
            level["resampled"] = {
                "n_drawn": n_re,
                "n_failed": int(re_res.n_failed),
                "solved_frac": round(float(re_res.solved_frac), 6),
                "mean_max_com_err_m": round(float(re_res.mean_com_err), 4),
            }
        levels_out.append(level)
    wall = time.time() - t0

    total = n_per * len(WIND_LEVELS)
    default = ScenarioConfig()
    record = {
        "metric": "robustness_sweep",
        "n_scenarios_total": total,
        "seconds": seconds,
        "n_ticks": n_ticks,
        "branch_airborne_at_s": skip_s,
        "thrust_scale_std": default.thrust_scale_std,
        "base_vel_std": default.base_vel_std,
        "joint_pos_std": default.joint_pos_std,
        "com_err_fail_m": 1.0,
        "levels": levels_out,
        "wall_s": round(wall, 1),
        "scenario_rollouts_per_s": round(total / wall, 2),
        "tick_solves_per_s": round(total * n_ticks / wall, 1),
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
