#!/usr/bin/env python
"""Real-time 200 Hz host driver of the PyTorch port: native pacer +
lock-free telemetry ring around the multi-rate MPC tick on a CUDA card
(counterpart of examples/realtime_driver.py).

The reference's timed control loop (src/variable_sampling_mpc.py:106-161)
as a hard-period loop that
  - waits on an absolute-deadline pacer (clock_nanosleep in
    native/ironcub_rt.cc; overrun accounting like the reference's deadline
    warning at :122-123),
  - runs one MPC tick on the held hover snapshot; the carry is reassigned
    tick by tick,
  - packs the tick's telemetry record on the device and copies it into a
    pinned host buffer: that copy is the tick's one wait for the device,
  - pushes the record into the native SPSC ring, drained to disk by a
    background thread (the control thread never touches the filesystem),
  - prints the rolling mean solve time + overrun count every 200 ticks
    (:116-119).

Usage:
  python examples/realtime_driver_torch.py [n_ticks] [period_ms] [--device cpu]

Defaults: 1000 ticks at the reference's 5 ms period on ``cuda``.
"""

import argparse
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from ironcub_mpc_tpu_torch import resolve_device
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc
from ironcub_mpc_tpu_torch.runtime.native import (RealtimePacer,
                                                  TelemetryRing, available)

RECORD_LEN = 16  # [tick, status, pri, dua, thr*4, T_des*4, solve_ms, spare*3]
DRIVER_SETTINGS = dict(max_iter=60, rho_update_iters=(15, 40))


def hover_setup(settings=None, device=None, cfg=None):
    """The hover problem of the JAX package's ``__graft_entry__._setup``
    from the port's modules: the calibrated Mk3 model at base z 0.8 with
    each jet at a quarter of the weight, zero trajectories, full gravity
    compensation, under ``cfg`` (the stock ``MPCConfig`` by default).
    Returns (cfg, sched, sel, settings, problem, carry, snapshot); the
    snapshot and the carry have one lane."""
    from ironcub_mpc_tpu_torch.core.config import (MPCConfig, RobotConfig,
                                                   SimConfig, joint_selector)
    from ironcub_mpc_tpu_torch.dynamics import (KinDyn, compute_snapshot,
                                                load_ironcub_model)
    from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule

    dev = resolve_device(device)
    cfg = cfg or MPCConfig()
    settings = settings or admm.ADMMSettings(max_iter=100)
    rc = RobotConfig()
    sched = build_schedule(cfg)
    sel = joint_selector(rc, cfg)
    model = load_ironcub_model()
    kd = KinDyn(model, device=dev)
    opts = dict(dtype=torch.float32, device=dev)
    q0 = torch.as_tensor(np.radians(SimConfig().initial_position_deg),
                         **opts)[None]
    hover = model.total_mass * 9.81 / 4.0
    snap = compute_snapshot(
        kd, rc.jets_list, torch.eye(3, **opts)[None],
        torch.tensor([[0.0, 0.0, 0.8]], **opts), torch.zeros((1, 6), **opts),
        q0, torch.zeros((1, 23), **opts), torch.full((1, 4), hover, **opts))
    channels = {k: np.zeros((30, 3)) for k in
                ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
    problem, carry = vs_mpc.configure(cfg, sched, sel, snap, channels,
                                      np.ones(600), settings, device=dev)
    return cfg, sched, sel, settings, problem, carry, snap


class HoverTick:
    """The driver's tick: one MPC tick on the held hover snapshot, its
    record [status, pri, dua, throttle*4, thrust_des*4] packed on the
    device and copied into a (pinned, on a card) host buffer — the tick's
    one wait for the device. ``tick()`` returns that buffer as numpy; the
    next tick writes over it."""

    N_OUT = 11

    def __init__(self, device=None):
        self.device = resolve_device(device)
        settings = admm.ADMMSettings(**DRIVER_SETTINGS)
        (self.cfg, self.sched, self.sel, self.settings, self.problem,
         self.carry, self.snap) = hover_setup(settings, self.device)
        self.est = torch.zeros((1, 4), dtype=torch.float32,
                               device=self.device)
        self._host = torch.empty(self.N_OUT, dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")

    def __call__(self) -> np.ndarray:
        self.carry, out = vs_mpc.mpc_tick(
            self.cfg, self.sched, self.sel, self.settings, self.problem,
            self.carry, self.snap, self.est)
        record = torch.cat([out.status.to(torch.float32), out.pri_res,
                            out.dua_res, out.throttle[0], out.thrust_des[0]])
        self._host.copy_(record)
        return self._host.numpy()


def run(n_ticks: int = 1000, period_s: float = 0.005,
        drain_path: str | None = None, verbose: bool = True, device=None,
        tick: HoverTick | None = None):
    """Warm up, then drive ``n_ticks`` paced ticks; returns the stats dict
    of the JAX driver plus ``device``. ``tick`` reuses a built
    :class:`HoverTick` (its carry goes on from where it stands)."""
    tick = tick or HoverTick(device)
    dev = tick.device
    # first launches, the allocator and the kernels' builds outside the
    # paced loop: enough un-paced ticks that everything is steady before
    # the first deadline is armed
    for _ in range(20):
        tick()

    ring = TelemetryRing(capacity=4096, record_len=RECORD_LEN)
    drain_path = drain_path or str(ROOT / "build" / "realtime_driver.f32")
    Path(drain_path).parent.mkdir(parents=True, exist_ok=True)
    Path(drain_path).unlink(missing_ok=True)
    stop = threading.Event()
    drained = [0]

    def drainer():
        while not stop.is_set():
            drained[0] += ring.drain_to_file(drain_path)
            time.sleep(0.02)
        drained[0] += ring.drain_to_file(drain_path)

    th = threading.Thread(target=drainer, daemon=True)
    th.start()

    import gc

    gc.collect()
    gc.freeze()     # survivors out of the young generations for good
    gc.disable()                      # no collector pauses inside the loop
    try:
        pacer = RealtimePacer(period_s)
        solve_times = np.zeros(n_ticks)
        overrun_events = []               # (tick, lateness_ms) per overrun
        rec = np.zeros(RECORD_LEN, np.float32)
        for i in range(n_ticks):
            late = pacer.wait()
            if late >= 0:   # >= : the pacer counters also count late == 0
                overrun_events.append((i, late * 1e3))
            t0 = time.perf_counter()
            host = tick()
            dt_ms = (time.perf_counter() - t0) * 1e3
            solve_times[i] = dt_ms
            rec[0] = i
            rec[1:1 + host.size] = host   # [status, pri, dua, thr*4, T_des*4]
            rec[1 + host.size] = dt_ms
            ring.push(rec)
            if verbose and (i + 1) % 200 == 0:
                # rolling report (variable_sampling_mpc.py:116-119)
                mean_ms = solve_times[max(0, i - 199):i + 1].mean()
                print(f"tick {i+1:5d}: mean solve {mean_ms:6.3f} ms | "
                      f"pacer overruns {pacer.overruns} "
                      f"(worst {pacer.worst_lateness*1e3:.2f} ms) | "
                      f"ring dropped {ring.dropped}")
    finally:
        gc.enable()
        gc.unfreeze()
        stop.set()
        th.join(timeout=2.0)
    # overrun forensics (the reference prints a per-overrun warning,
    # variable_sampling_mpc.py:122-123): classify every overrun by tick
    # index so warmup transients and steady-state misses are separable
    warmup_n = 50
    n_warm = sum(1 for t, _ in overrun_events if t < warmup_n)
    # a single long stall shows up as a decaying BURST of consecutive
    # overruns under absolute-deadline pacing (the pacer never skips
    # deadlines): count distinct stall events = overruns whose previous
    # tick was on time
    ticks_set = {t for t, _ in overrun_events}
    n_stalls = sum(1 for t, _ in overrun_events if (t - 1) not in ticks_set)
    stats = dict(
        ticks=n_ticks,
        native=available(),
        mean_solve_ms=float(solve_times.mean()),
        p99_solve_ms=float(np.percentile(solve_times, 99)),
        overruns=pacer.overruns,
        worst_lateness_ms=pacer.worst_lateness * 1e3,
        overruns_warmup=n_warm,                  # tick < 50
        overruns_steady=len(overrun_events) - n_warm,
        stall_events=n_stalls,                   # distinct bursts
        overrun_events=[[int(t), round(l, 3)]
                        for t, l in overrun_events[:100]],
        ring_dropped=ring.dropped,
        drained_records=drained[0],
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev)),
    )
    if verbose:
        budget = period_s * 1e3
        print(f"\n{n_ticks} ticks @ {budget:.1f} ms period on "
              f"{stats['device']} (native runtime: {stats['native']})")
        print(f"solve: mean {stats['mean_solve_ms']:.3f} ms, "
              f"p99 {stats['p99_solve_ms']:.3f} ms (budget {budget:.1f} ms)")
        print(f"pacer: {stats['overruns']} overruns "
              f"({n_warm} warmup / {stats['overruns_steady']} steady), "
              f"worst lateness {stats['worst_lateness_ms']:.3f} ms")
        for t, l in overrun_events[:20]:
            print(f"  overrun at tick {t}: {l:.2f} ms late")
        print(f"telemetry: {stats['drained_records']} records drained to "
              f"{drain_path}, {stats['ring_dropped']} dropped")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ticks", nargs="?", type=int, default=1000)
    ap.add_argument("period_ms", nargs="?", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.n_ticks, args.period_ms / 1e3, device=args.device)


if __name__ == "__main__":
    main()
