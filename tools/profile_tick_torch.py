#!/usr/bin/env python
"""Break one batched condensed MPC tick of the PyTorch port into stages and
time each (counterpart of tools/profile_tick.py).

Usage: python tools/profile_tick_torch.py [batch=512] [--iters 20]
           [--device cuda]

At the hover state of ``examples/realtime_driver_torch.hover_setup``
(solver: 60 iterations, polish, ρ marks at 15 and 40, per-lane decisions)
with ``batch`` lanes whose momentum carries a seeded jitter, it times, each
on the host clock over ``--iters`` calls between two synchronisations:

  tick_prep(linearize)       reference shift, linearisation, x0, pin
  condense                   the state elimination
  solve(admm+polish)         the box-QP solve
  solve(no polish)           ... without the polish
  solve(no polish, no rho)   ... without the adaptive-ρ refreshes
  solve(+no scaling)         ... without the equilibration
  finish(extract)            command integration and the output
  FULL tick                  all of it through ``mpc_tick``

Each solve variant equilibrates and factorises afresh from the
configure-time warm start (no carried inverse), as the JAX tool's. The
CUDA kernels run (``kernel_mode="auto"``, JAX's default ``pallas_mode``).
Runs on ``cuda`` unless ``--device`` says otherwise. Ends with one JSON
line: the stage times, the kernel launches a FULL tick and ``"device"``,
the card's name and power limit.
"""

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from common_torch import (batched_hover, device_entry, host_ms,  # noqa: E402
                          option, positional)

VALUED = ("iters", "device")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, VALUED)
    batch = int(pos[0]) if pos else 512
    iters = int(option(argv, "iters", 20))

    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc

    settings = admm.ADMMSettings(max_iter=60, polish=True,
                                 rho_update_iters=(15, 40),
                                 kernel_mode="auto")
    cfg, sched, sel, settings, problem, carries, snaps, est = batched_hover(
        batch, settings, device=option(argv, "device"))
    dev = carries.warm_x.device
    print(f"# one condensed tick in stages, batch={batch}, {iters} calls "
          f"each, device={device_entry(dev)}", flush=True)
    ms = {}

    def bench(name, fn):
        out = fn()
        ms[name] = host_ms(fn, dev, iters, warmup=0)
        print(f"{name:28s} {ms[name]:8.3f} ms  "
              f"({batch / ms[name] * 1e3:10.0f} /s)", flush=True)
        return out

    carries2, prep = bench("tick_prep(linearize)", lambda: vs_mpc._tick_prep(
        cfg, sel, problem, carries, snaps, est))
    qp = bench("condense", lambda: vs_mpc.condense_from_prep(
        cfg, sched, sel, problem, carries2, prep)[0])

    def solve_with(**over):
        s = dataclasses.replace(settings, **over)
        return lambda: condensed.solve(cfg, qp, s, warm_u=carries2.warm_x,
                                       warm_y=carries2.warm_y)

    csol = bench("solve(admm+polish)", solve_with())
    bench("solve(no polish)", solve_with(polish=False))
    bench("solve(no polish, no rho)", solve_with(polish=False,
                                                 rho_update_iters=()))
    bench("solve(+no scaling)", solve_with(polish=False, rho_update_iters=(),
                                           scaling_iters=0))
    bench("finish(extract)", lambda: vs_mpc.extract_condensed(
        cfg, sel, carries2, csol, settings))

    K.reset_launches()
    bench("FULL tick", lambda: vs_mpc.mpc_tick(cfg, sched, sel, settings,
                                               problem, carries, snaps, est))
    calls = iters + 1
    launches = {"admm_segment": K.admm_segment.launches / calls,
                "woodbury_ns": K.woodbury_ns.launches / calls}
    record = {"tool": "profile_tick", "batch": batch, "iters": iters,
              "kernel_mode": settings.kernel_mode, "ms": ms,
              "launches_per_tick": launches, "device": device_entry(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
