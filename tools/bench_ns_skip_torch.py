#!/usr/bin/env python
"""A/B the probe-gated carried-inverse refresh skip
(``ADMMSettings.ns_skip_tol``) in the PyTorch port (counterpart of
tools/bench_ns_skip.py).

Chained throughput of the batched tick (bench settings: ``max_iter=40``, ρ
mark at 15, polish, the guard, batch-wide decisions, the kernels on) for
ns_skip_tol=0 (refresh every tick) against 0.02, at two per-tick
snapshot-jitter levels, at the hover state of
``examples/realtime_driver_torch.hover_setup`` with a seeded momentum
jitter a lane:

  jitter=0.0  H constant across ticks: every probe passes, the upper bound
              of the skip's win.
  jitter>0    a fresh momentum jitter every tick, the 200 Hz
              relinearisation drift of a flight: the probe residual grows
              between refreshes, the honest regime.

Where the JAX tool times a ``lax.scan``, this one times a Python loop of
chained eager ticks: one chain to warm up, then three timed on the host
clock between two synchronisations, the carry continuing. The per-tick
jitter is drawn once from numpy's generator (seed 0) and is the same in
every chain and arm. solved= averages the last timed chain.

Usage: python tools/bench_ns_skip_torch.py [batch=256] [scan_len=50]
           [--reps 3] [--device cuda]

The JAX tool switches its Pallas kernels off; here the CUDA kernels run, as
in the sweep tools (their plain twins are 20–40× slower on the card,
PERF.md §6). Runs on ``cuda`` unless ``--device`` says otherwise. Ends with
one JSON line of the solves/s, the kernels' launches a tick of each arm
and ``"device"``, the card's name and power limit.
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

from common_torch import (batched_hover, device_entry, option,  # noqa: E402
                          positional, sync)

VALUED = ("reps", "device")
ARMS = (("refresh_every_tick", 0.0), ("skip_tol_0.02", 0.02))
JITTERS = (0.0, 0.2)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, VALUED)
    batch = int(pos[0]) if pos else 256
    scan_len = int(pos[1]) if len(pos) > 1 else 50
    reps = int(option(argv, "reps", 3))

    import torch

    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc

    base = admm.ADMMSettings(max_iter=40, polish=True, rho_update_iters=(15,),
                             kernel_mode="auto",
                             kinv_guard=True, batch_guard=True)
    noise = np.random.default_rng(0).standard_normal((scan_len, batch, 6))
    results, launches = {}, {}
    dev = None
    for name, tol in ARMS:
        settings = dataclasses.replace(base, ns_skip_tol=tol)
        cfg, sched, sel, settings, problem, carries0, snaps, est = \
            batched_hover(batch, settings, device=option(argv, "device"))
        if dev is None:
            dev = carries0.warm_x.device
            print(f"# refresh-skip A/B, batch={batch}, scan_len={scan_len}, "
                  f"device={device_entry(dev)}", flush=True)
        steps = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        for jitter in JITTERS:
            def chain(cc):
                oks = []
                for k in range(scan_len):
                    s_t = snaps._replace(momentum_body=snaps.momentum_body
                                         + jitter * steps[k])
                    cc, out = vs_mpc.mpc_tick(cfg, sched, sel, settings,
                                              problem, cc, s_t, est)
                    oks.append(((out.status == admm.SOLVED)
                                | (out.status == admm.SOLVED_INACCURATE)
                                ).float().mean())
                return cc, torch.stack(oks).mean()

            carries, ok = chain(carries0)
            K.reset_launches()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                carries, ok = chain(carries)
            sync(dev)
            dt = (time.perf_counter() - t0) / reps / scan_len
            n = reps * scan_len
            launches[f"{name} jitter={jitter}"] = {
                "admm_segment": K.admm_segment.launches / n,
                "woodbury_ns": K.woodbury_ns.launches / n}
            sps, solved = batch / dt, float(ok)
            results[(name, jitter)] = (sps, solved)
            print(f"{name:22s} jitter={jitter:4.2f}  {sps:9.0f} solves/s  "
                  f"solved={solved:.3f}", flush=True)

    gains = {}
    for jitter in JITTERS:
        a = results[("refresh_every_tick", jitter)][0]
        b = results[("skip_tol_0.02", jitter)][0]
        gains[str(jitter)] = 100 * (b / a - 1)
        print(f"jitter={jitter}: skip is {gains[str(jitter)]:+.1f}%")
    record = {"tool": "bench_ns_skip", "batch": batch, "scan_len": scan_len,
              "reps": reps, "kernel_mode": base.kernel_mode,
              "solves_per_s": {f"{n} jitter={j}": v[0]
                               for (n, j), v in results.items()},
              "solved": {f"{n} jitter={j}": v[1]
                         for (n, j), v in results.items()},
              "skip_gain_pct": gains, "launches_per_tick": launches,
              "device": device_entry(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
