#!/usr/bin/env python
"""Batch-1 latency of the joint-limits configuration in the PyTorch port
(counterpart of tools/bench_joint_limits_latency.py).

With ``use_joint_position_constraint=True`` the condensed box widens to the
whole input (nU = 120, n_box = 120, box0 = 0, padded to P = 128), so the
carried-inverse refresh is ``woodbury_ns``'s tuned route at n_box 120. The
tool chains ``chain`` batch-1 ticks at the hover state of
``examples/realtime_driver_torch.hover_setup`` (``max_iter=40``, ρ mark at
15, polish, the guard) with the CUDA kernels (``kernel_mode="on"``) and
without them (``"off"``, the unpadded plain PyTorch path): one chain to warm
up and give the solved fraction, then five timed on the host clock between
two synchronisations, and prints the median ms a solve. Where the JAX tool
times a ``lax.scan``, this one times a Python loop of chained eager ticks.

Usage: python tools/bench_joint_limits_latency_torch.py [chain=100]
           [--device cuda]

Runs on ``cuda`` unless ``--device`` says otherwise. Ends with one JSON
line of both modes' p50, solved fraction and kernel launches a tick, and
``"device"``, the card's name and power limit.
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

TIMED_CHAINS = 5


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, valued=("device",))
    chain = int(pos[0]) if pos else 100

    from ironcub_mpc_tpu_torch.core.config import MPCConfig
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc

    cfg0 = dataclasses.replace(MPCConfig(),
                               use_joint_position_constraint=True)
    base = admm.ADMMSettings(max_iter=40, polish=True,
                             rho_update_iters=(15,), kinv_guard=True)
    n_box = condensed.n_box(cfg0)
    out = {}
    for mode in ("off", "on"):
        settings = dataclasses.replace(base, kernel_mode=mode)
        cfg, sched, sel, settings, problem, carry, snap, est = batched_hover(
            1, settings, device=option(argv, "device"), cfg=cfg0, jitter=0.0)
        dev = carry.warm_x.device

        def chain_fn(c):
            st = []
            for _ in range(chain):
                c, o = vs_mpc.mpc_tick(cfg, sched, sel, settings, problem, c,
                                       snap, est)
                st.append(o.status)
            return c, st

        c1, st = chain_fn(carry)
        st = np.concatenate([s.cpu().numpy() for s in st])
        solved = float(np.mean((st == admm.SOLVED)
                               | (st == admm.SOLVED_INACCURATE)))
        K.reset_launches()
        seq = []
        for _ in range(TIMED_CHAINS):
            sync(dev)
            t0 = time.perf_counter()
            c1, _ = chain_fn(c1)
            sync(dev)
            seq.append((time.perf_counter() - t0) / chain)
        n = TIMED_CHAINS * chain
        p50 = float(np.median(seq) * 1e3)
        out[mode] = dict(p50_ms=p50, solved_frac=solved, launches_per_tick={
            "admm_segment": K.admm_segment.launches / n,
            "woodbury_ns": K.woodbury_ns.launches / n})
        print(f"joint-limits n_box={n_box} kernel_mode={mode}: "
              f"p50={p50:.3f} ms/solve (deadline 5 ms), "
              f"solved_frac={solved:.3f}, device={device_entry(dev)}",
              flush=True)
    record = {"tool": "bench_joint_limits_latency", "chain": chain,
              "n_box": n_box, "modes": out, "device": device_entry(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
