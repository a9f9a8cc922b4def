#!/usr/bin/env python
"""Benchmark of the PyTorch port: multi-rate MPC solves/s on one card (the
counterpart of bench.py).

Measures bench.py's timed quantity, the reference's update + solveMPC
(variable_sampling_mpc.py:110-114): per-tick linearisation, condensing,
the carried-K⁻¹ refresh, the warm-started ADMM solve with polish and the
command extraction, at the full multi-rate horizon (nU = 120, padded to
P = 128), batched over lanes. The headline regime replays the recorded
flight stream (tests/golden/flight_snapshots.npz through
``runtime/replay.py``): tick t takes snapshot frame t+1 and est_td[t]
(``FlightReplay.tick_inputs``), so every chained tick feeds another full
RobotSnapshot. BENCH_STATIC=1 replays frame 1 with a zero est_td on every
tick instead, as bench.py's static regime.

Regimes, as bench.py's:

- throughput: BENCH_BATCH lanes (256), batch-wide decisions, one warm-up
  chain, then 3 timed chains of BENCH_SCAN ticks (100), each synchronised
  once at its end. ``value`` is solves/s, the batch over the seconds a tick
  takes; ``solved_frac`` the mean over lane-ticks of SOLVED or
  SOLVED_INACCURATE. Then the per-dispatch loop: BENCH_ITERS ticks (10) on
  the static snapshot, synchronised once. PyTorch has no ``lax.scan``: a
  chain is a Python loop of eager ticks, so both loops pay the host's
  launches, which is what the port's users pay.
- latency: batch 1, per-lane decisions. ``single_solve_p50_ms`` is the
  median of 5 chains of BENCH_SCAN ticks, each synchronised once, over the
  ticks of a chain; the host round trip (30 times: a priming tick, a
  synchronise, then one timed tick synchronised) goes to stderr only.

Settings: bench.py's (``max_iter`` 40, polish, a ρ update at 15, the
carried-inverse guard, ``ns_skip_tol`` 0.02, ``term_check_every`` 5, eps
BENCH_EPS = 1e-3), batch-wide decisions for throughput and per-lane ones
for latency. One departure: both regimes run ``kernel_mode="auto"``,
where bench.py runs its throughput regime with ``pallas_mode="off"``. In
the port ``"off"`` is the unpadded box-layout path
(ironcub_mpc_tpu_torch/ops/admm.py), which launches none of the
hand-written kernels, and bench.py grounds its choice in a TPU v5e
measurement (bench.py:68-75) that no run on the H100 repeats.

Lanes differ by a momentum jitter of 0.1·N(0, 1) [batch, 6] from numpy's
``default_rng(0)``, as chip_smoke.py and tests/test_torch_tick.py draw
it; bench.py's threefry draw cannot be reproduced without JAX.

``vs_baseline`` divides by 200 solves/s, the reference controller's own
rate of one solve per 5 ms tick (the contract bench.py:193-194 cites),
never by BASELINE.json's 5,000, a target for a TPU slice.

BENCH_MESH=1 runs the throughput regime over the processes that
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` describe,
one a card (``parallel/mesh.py``): each rank runs its ``scenario_shard``
of the lanes, the slowest rank's times count, each rank runs the latency
regime on its own card, and rank 0 alone prints (its latency). With one
process it is the plain run.

Prints ONE JSON line on stdout, bench.py's keys in bench.py's order and
then ``device`` (the card's name and power limit as ``nvidia-smi``
prints them), and one line of detail on stderr: bench.py's fields, the
host read-backs a tick and each kernel's launches.

Usage: python bench_torch.py [--device cuda]
Knobs (environment, bench.py's): BENCH_BATCH=256, BENCH_ITERS=10,
BENCH_SCAN=100, BENCH_EPS=1e-3, BENCH_STATIC=0, BENCH_MESH=0.

Runs on ``cuda`` unless --device says otherwise. On a card it raises if
``admm_segment`` or ``woodbury_ns`` did not launch in either regime, or
if a lane-tick was not solved; on the CPU the kernels' plain twins run.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from common_torch import device_entry, option, sync  # noqa: E402

REFERENCE_SOLVES_PER_S = 200.0      # one solve per 5 ms tick
DEADLINE_MS = 5.0
REPS, LATENCY_CHAINS, ROUND_TRIPS = 3, 5, 30
KERNELS = ("admm_segment", "woodbury_ns")


def bench_settings(eps: float, batch_guard: bool):
    """bench.py's solver settings on the port, the kernels on."""
    from ironcub_mpc_tpu_torch.ops import admm

    return admm.ADMMSettings(max_iter=40, polish=True, rho_update_iters=(15,),
                             kinv_guard=True, batch_guard=batch_guard,
                             ns_skip_tol=0.02, term_check_every=5,
                             eps_abs=eps, eps_rel=eps, kernel_mode="auto")


def lane_jitter(batch: int) -> np.ndarray:
    """The lanes' momentum jitter, 0.1·N(0, 1) [batch, 6] float32."""
    return (0.1 * np.random.default_rng(0).standard_normal((batch, 6))
            ).astype(np.float32)


def stream_inputs(replay, scan_len: int, n: int, jitter=None,
                  static: bool = False) -> list:
    """(snapshot, est_thrust_dot) of each of ``scan_len`` chained ticks for
    ``n`` lanes: frames 1..scan_len of the stream, or frame 1 with a zero
    est_td on every tick when ``static``."""
    if static:
        snap, est = replay.tick_inputs(0, n, jitter)
        return [(snap, torch.zeros_like(est))] * scan_len
    return [replay.tick_inputs(t, n, jitter) for t in range(scan_len)]


def make_tick(replay, settings, problem):
    from ironcub_mpc_tpu_torch.qp import mpc

    def tick(carry, snap, est):
        return mpc.mpc_tick(replay.cfg, replay.sched, replay.sel, settings,
                            problem, carry, snap, est)
    return tick


def chain(tick, carry, inputs):
    """``tick`` chained over ``inputs``; (carry, the ticks' outputs). Waits
    for nothing: the caller synchronises."""
    outs = []
    for snap, est in inputs:
        carry, out = tick(carry, snap, est)
        outs.append(out)
    return carry, outs


def solved_frac(outs) -> float:
    from ironcub_mpc_tpu_torch.ops import admm

    st = torch.stack([o.status for o in outs])
    ok = (st == admm.SOLVED) | (st == admm.SOLVED_INACCURATE)
    return float(ok.double().mean())


def _counters():
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import condensed

    return ({k: getattr(K, k).launches for k in KERNELS},
            condensed.batch_any.syncs)


def _reset_counters():
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import condensed

    K.reset_launches()
    condensed.batch_any.syncs = 0


def throughput(replay, settings, batch: int, scan_len: int, iters: int,
               static: bool = False, lanes: slice = slice(None)) -> dict:
    """The throughput regime on ``lanes`` of the ``batch`` lanes: seconds a
    chained tick, seconds of the per-dispatch loop, the solved fraction, and
    the kernel launches and host read-backs of the 3 timed chains."""
    from ironcub_mpc_tpu_torch.core.types import expand_lanes

    dev = replay.est_td.device
    jitter = torch.as_tensor(lane_jitter(batch)[lanes], device=dev)
    n = jitter.shape[0]
    problem, carry = replay.configure(settings)
    tick = make_tick(replay, settings, problem)
    inputs = stream_inputs(replay, scan_len, n, jitter, static)
    snap0, est0 = stream_inputs(replay, 1, n, jitter, static=True)[0]
    carries = expand_lanes(carry, n)

    t0 = time.perf_counter()
    carries, _ = chain(tick, carries, inputs)
    carries, _ = tick(carries, snap0, est0)
    sync(dev)
    warmup_s = time.perf_counter() - t0

    _reset_counters()
    outs = []
    t0 = time.perf_counter()
    for _ in range(REPS):
        carries, o = chain(tick, carries, inputs)
        outs += o
    sync(dev)
    tick_s = (time.perf_counter() - t0) / REPS / scan_len
    launches, syncs = _counters()

    t0 = time.perf_counter()
    for _ in range(iters):
        carries, _ = tick(carries, snap0, est0)
    sync(dev)
    dispatch_s = time.perf_counter() - t0
    return dict(lanes=n, tick_s=tick_s, dispatch_s=dispatch_s,
                solved_frac=solved_frac(outs), warmup_s=warmup_s,
                launches=launches, syncs_per_tick=syncs / (REPS * scan_len))


def latency(replay, settings, scan_len: int) -> dict:
    """The latency regime at batch 1: ms a tick of each of 5 chains, the
    host round trips, the solved fraction and the chains' launches."""
    dev = replay.est_td.device
    problem, carry = replay.configure(settings)
    tick = make_tick(replay, settings, problem)
    inputs = stream_inputs(replay, scan_len, 1)

    c, _ = chain(tick, carry, inputs)
    sync(dev)
    _reset_counters()
    seq_ms, outs = [], []
    for _ in range(LATENCY_CHAINS):
        t0 = time.perf_counter()
        c, o = chain(tick, c, inputs)
        sync(dev)
        seq_ms.append(1e3 * (time.perf_counter() - t0) / scan_len)
        outs += o
    launches, syncs = _counters()

    (snap1, est1), (snap2, est2) = stream_inputs(replay, 2, 1)
    c2, _ = tick(carry, snap1, est1)
    sync(dev)
    trips_ms = []
    for _ in range(ROUND_TRIPS):
        c2, _ = tick(c2, snap1, est1)
        sync(dev)                     # the timed tick must not inherit this
        t0 = time.perf_counter()      # priming tick's queue
        c2, _ = tick(c2, snap2, est2)
        sync(dev)
        trips_ms.append(1e3 * (time.perf_counter() - t0))
    return dict(p50_ms=float(np.median(seq_ms)),
                round_trip_p50_ms=float(np.median(trips_ms)),
                solved_frac=solved_frac(outs), launches=launches,
                syncs_per_tick=syncs / (LATENCY_CHAINS * scan_len))


def _over_ranks(values, op: str, dev, mesh) -> list:
    """``values`` reduced over the mesh's ranks by ``op`` ("MAX" or "SUM"
    of ``torch.distributed.ReduceOp``); as they are without a mesh."""
    if mesh is None or mesh.world_size == 1:
        return list(values)
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
    return t.tolist()


def _join_mesh(batch: int, device):
    """(mesh, this rank's lanes) of BENCH_MESH=1."""
    from ironcub_mpc_tpu_torch.parallel.mesh import (
        make_mesh, multihost_init, scenario_shard)

    multihost_init()
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if batch % world:
        raise ValueError(f"BENCH_BATCH={batch} does not divide over "
                         f"{world} processes")
    mesh = make_mesh(n_scenario=world, n_kkt=1, device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    if mesh.rank == 0:
        print(f"# BENCH_MESH: {world} processes, {batch // world} "
              "scenarios/process", file=sys.stderr)
    return mesh, scenario_shard(mesh, batch)


def main(argv=None):
    """Run both regimes; print the JSON line (rank 0) and return it with
    the detail of each regime."""
    argv = sys.argv[1:] if argv is None else list(argv)
    batch = int(os.environ.get("BENCH_BATCH", "256"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    scan_len = int(os.environ.get("BENCH_SCAN", "100"))
    eps = float(os.environ.get("BENCH_EPS", "1e-3"))
    static = os.environ.get("BENCH_STATIC", "0") == "1"

    from ironcub_mpc_tpu_torch import resolve_device
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    mesh, lanes = None, slice(None)
    if os.environ.get("BENCH_MESH", "0") == "1":
        mesh, lanes = _join_mesh(batch, option(argv, "device"))
        dev = mesh.device
    else:
        dev = resolve_device(option(argv, "device"))
    replay = load_flight_replay(device=dev)
    if scan_len > replay.n_ticks:
        raise ValueError(f"BENCH_SCAN={scan_len} beyond the "
                         f"{replay.n_ticks} recorded ticks")

    tput = throughput(replay, bench_settings(eps, batch_guard=True), batch,
                      scan_len, iters, static, lanes)
    lat = latency(replay, bench_settings(eps, batch_guard=False), scan_len)
    # the slowest rank's times; the ranks' equal shares of the lanes
    tick_s, dispatch_s = _over_ranks([tput["tick_s"], tput["dispatch_s"]],
                                     "MAX", dev, mesh)
    solved = _over_ranks([tput["solved_frac"]], "SUM", dev, mesh)[0] / (
        1 if mesh is None else mesh.world_size)
    solves_per_s = batch / tick_s
    dispatch_solves_per_s = batch * iters / dispatch_s

    if dev.type == "cuda":
        for name, run in (("throughput", tput), ("latency", lat)):
            for k, n in run["launches"].items():
                if n == 0:
                    raise RuntimeError(f"bench: {k} was never launched on "
                                       f"the {name} path")
        for name, frac in (("throughput", solved),
                           ("latency", lat["solved_frac"])):
            if frac < 1.0:
                raise RuntimeError(f"bench: solved fraction {frac} < 1.0 "
                                   f"on the {name} path")

    result = {
        "metric": "mpc_solves_per_s",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / REFERENCE_SOLVES_PER_S, 3),
        "single_solve_p50_ms": round(lat["p50_ms"], 3),
        "deadline_ms": DEADLINE_MS,
        "solved_frac": round(solved, 4),
        "per_dispatch_solves_per_s": round(dispatch_solves_per_s, 1),
        "regime": "static" if static else "flight_replay",
        "device": device_entry(dev),
    }
    if mesh is None or mesh.rank == 0:
        print(json.dumps(result), flush=True)
        print(f"# device={dev} batch={batch} scan_len={scan_len} "
              f"warmup={tput['warmup_s']:.1f}s "
              f"tick={1e3 * tick_s:.3f}ms "
              f"({'static-snapshot' if static else 'recorded-flight replay'}"
              " chained eager ticks) "
              f"per_dispatch={dispatch_solves_per_s:.0f}/s "
              f"solved_frac={solved:.3f} "
              f"single_solve_p50={lat['p50_ms']:.3f}ms (chained, deadline "
              f"{DEADLINE_MS:g}ms) "
              f"host_roundtrip_p50={lat['round_trip_p50_ms']:.3f}ms "
              f"host_readbacks/tick={tput['syncs_per_tick']:.2f} (batch "
              f"{tput['lanes']}) / {lat['syncs_per_tick']:.2f} (batch 1) "
              f"launches={tput['launches']} / {lat['launches']}",
              file=sys.stderr, flush=True)
    if mesh is not None and mesh.world_size > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return result, dict(throughput=tput, latency=lat)


if __name__ == "__main__":
    main()
