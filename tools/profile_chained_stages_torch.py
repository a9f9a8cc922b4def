#!/usr/bin/env python
"""Budget the PyTorch port's tick in the chained replay regime (counterpart
of tools/profile_chained_stages.py).

Chains whole ticks over the recorded flight stream (bench settings:
``max_iter=40``, ρ mark at 15, batch-wide decisions, the probe gate at
0.02, the early exit every 5 iterations, the kernels on), as the JAX tool
does, and differences the per-tick time of tick variants with single
stages cut. Where the JAX tool times a ``lax.scan`` of chained ticks, this
one times a Python loop of chained eager ticks:

  variant            what it isolates (by difference against the full tick)
  -----------------  -------------------------------------------------------
  prep_only          _tick_prep (reference shift, linearise, x0)
  prep_condense      + condense  -> solve = full - this
  no_polish          the Schur polish
  no_guard           the kinv_guard probe and recovery
  no_ns_skip         the refresh with the probe gate off (every tick)
  term_off           the early-exit win (a fixed 40 iterations)
  iters sweep        the per-iteration slope (early exit off), max_iter in
                     {10, 20, 30, 40}

and the max_iter economics: solved fraction and command distance to a
400-iteration solve over the same stream, for max_iter in {20, 25, 30, 40}
(early exit on, per-lane decisions, batch 1).

Usage: python tools/profile_chained_stages_torch.py [batch=256]
           [scan_len=50] [--reps 3] [--device cuda]

Each variant's chain runs once to warm up and ``--reps`` times timed on the
host clock between two synchronisations, its carry continuing. The JAX
tool switches its Pallas kernels off (on a TPU the batched matmuls were
faster); here the CUDA kernels run, as in the sweep tools: their plain
twins are 20–40× slower on the card (PERF.md §6). Runs on ``cuda`` unless
``--device`` says otherwise. Ends with one JSON line of the times, the
kernels' launches a full tick and ``"device"``, the card's name and power
limit.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

from common_torch import device_entry, option, positional, sync  # noqa: E402

VALUED = ("reps", "device")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, VALUED)
    batch = int(pos[0]) if pos else 256
    scan_len = int(pos[1]) if len(pos) > 1 else 50
    reps = int(option(argv, "reps", 3))

    import torch

    from ironcub_mpc_tpu_torch.core.types import expand_lanes
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    replay = load_flight_replay(device=option(argv, "device"))
    cfg, sched, sel = replay.cfg, replay.sched, replay.sel
    dev = replay.est_td.device
    if scan_len > replay.n_ticks:
        raise SystemExit(f"scan_len {scan_len} > the stream's "
                         f"{replay.n_ticks} ticks")
    lane_jitter = torch.as_tensor(
        0.1 * np.random.default_rng(0).standard_normal((batch, 6)),
        dtype=torch.float32, device=dev)
    inputs = [replay.tick_inputs(t, batch, lane_jitter)
              for t in range(scan_len)]
    base = admm.ADMMSettings(max_iter=40, polish=True, rho_update_iters=(15,),
                             kernel_mode="auto",
                             kinv_guard=True, batch_guard=True,
                             ns_skip_tol=0.02, term_check_every=5)

    def measure(settings, stage="full"):
        """Chained ms a tick of a tick variant and its solved fraction;
        ``stage`` cuts the tick after prep or condense."""
        problem, carry = replay.configure(settings)
        carries = expand_lanes(carry, batch)

        def tick(c, snap, est):
            if stage == "full":
                c, out = vs_mpc.mpc_tick(cfg, sched, sel, settings, problem,
                                         c, snap, est)
                return c, ((out.status == admm.SOLVED)
                           | (out.status == admm.SOLVED_INACCURATE)
                           ).float().mean()
            c2, prep = vs_mpc._tick_prep(cfg, sel, problem, c, snap, est)
            if stage == "prep_only":
                return c2, (prep.x0.sum() + prep.lin.Ac.sum()
                            + prep.state_ref.sum())
            qp = vs_mpc.condense_from_prep(cfg, sched, sel, problem, c2,
                                           prep)[0]
            return c2, qp.H.sum() + qp.q.sum() + qp.F.sum()

        def chain(cc):
            rs = []
            for snap, est in inputs:
                cc, r = tick(cc, snap, est)
                rs.append(r)
            return cc, torch.stack(rs).mean()

        carries, r = chain(carries)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            carries, r = chain(carries)
        sync(dev)
        ms = (time.perf_counter() - t0) / reps / scan_len * 1e3
        return ms, float(r) if stage == "full" else float("nan")

    print(f"# chained replay regime, batch={batch}, scan_len={scan_len}, "
          f"device={device_entry(dev)}", flush=True)
    K.reset_launches()
    full_ms, full_ok = measure(base, "full")
    n_full = (reps + 1) * scan_len
    launches = {"admm_segment": K.admm_segment.launches / n_full,
                "woodbury_ns": K.woodbury_ns.launches / n_full}
    rows = [("full tick", full_ms, full_ok)]
    for name, settings, stage in (
        ("prep_only", base, "prep_only"),
        ("prep_condense", base, "prep_condense"),
        ("no_polish", dataclasses.replace(base, polish=False), "full"),
        ("no_guard", dataclasses.replace(base, kinv_guard=False), "full"),
        ("no_ns_skip", dataclasses.replace(base, ns_skip_tol=0.0), "full"),
        ("term_off", dataclasses.replace(base, term_check_every=0), "full"),
    ):
        ms, ok = measure(settings, stage)
        rows.append((name, ms, ok))
    for name, ms, ok in rows:
        print(f"{name:16s} {ms:7.3f} ms/tick"
              + ("" if np.isnan(ok) else f"  solved={ok:.3f}"), flush=True)
    d = {n: m for n, m, _ in rows}
    budget = {
        "prep": d["prep_only"],
        "condense": d["prep_condense"] - d["prep_only"],
        "solve (all)": d["full tick"] - d["prep_condense"],
        "polish": d["full tick"] - d["no_polish"],
        "guard probe/cond": d["full tick"] - d["no_guard"],
        "refresh (gated)": d["no_ns_skip"] - d["full tick"],
        "early-exit win": d["term_off"] - d["full tick"],
    }
    print(f"\n# stage budget by difference (batch {batch}):")
    print(f"prep                {budget['prep']:7.3f} ms")
    print(f"condense            {budget['condense']:7.3f} ms")
    print(f"solve (all)         {budget['solve (all)']:7.3f} ms")
    print(f"  polish            {budget['polish']:7.3f} ms")
    print(f"  guard probe/cond  {budget['guard probe/cond']:7.3f} ms")
    print(f"  refresh (gated)   {budget['refresh (gated)']:7.3f} ms "
          "(cost of refreshing every tick instead)")
    print(f"  early-exit win    {budget['early-exit win']:7.3f} ms")

    print("\n# per-iteration slope (term_check off):", flush=True)
    it_ms = {}
    for mi in (10, 20, 30, 40):
        ms, ok = measure(dataclasses.replace(
            base, term_check_every=0, max_iter=mi,
            rho_update_iters=(15,) if mi > 15 else ()), "full")
        it_ms[mi] = ms
        print(f"max_iter={mi:3d}  {ms:7.3f} ms/tick  solved={ok:.3f}",
              flush=True)
    slope = (it_ms[40] - it_ms[20]) / 20.0
    print(f"slope ~{slope * 1e3:.1f} us/iteration "
          f"(~{40 * slope:.3f} ms of the fixed-40 tick is iterations)")

    print("\n# max_iter economics (early exit on, vs max_iter=400 golden):",
          flush=True)

    def run_commands(settings):
        problem, carry = replay.configure(settings)
        cols = []
        for t in range(scan_len):
            carry, out = vs_mpc.mpc_tick(cfg, sched, sel, settings, problem,
                                         carry, *replay.tick_inputs(t))
            cols.append((out.status, out.throttle, out.joints_pos_ref,
                         out.thrust_des))
        return tuple(torch.cat(c).cpu().numpy() for c in zip(*cols))

    golden = run_commands(dataclasses.replace(
        base, batch_guard=False, max_iter=400,
        rho_update_iters=(25, 75, 150), term_check_every=0))
    economics = {}
    for mi in (20, 25, 30, 40):
        st, thr, jp, td = run_commands(dataclasses.replace(
            base, batch_guard=False, max_iter=mi,
            rho_update_iters=(15,) if mi > 15 else ()))
        ok = float(np.mean((st == 1) | (st == 2)))
        economics[mi] = dict(
            solved=ok, throttle=float(np.abs(thr - golden[1]).max()),
            joint=float(np.abs(jp - golden[2]).max()),
            thrust=float(np.abs(td - golden[3]).max()))
        print(f"max_iter={mi:3d}: solved={ok:.3f}  "
              f"max|dThrottle|={economics[mi]['throttle']:.4f}%  "
              f"max|dJoint|={economics[mi]['joint']:.5f} rad  "
              f"max|dThrust|={economics[mi]['thrust']:.4f} N", flush=True)
    record = {"tool": "profile_chained_stages", "batch": batch,
              "scan_len": scan_len, "reps": reps,
              "kernel_mode": base.kernel_mode,
              "ms_per_tick": d, "budget_ms": budget, "iters_ms": it_ms,
              "slope_us_per_iteration": slope * 1e3,
              "max_iter_economics": economics,
              "launches_per_tick": launches, "device": device_entry(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
