#!/usr/bin/env python3
"""Drive the PyTorch port of the multi-rate MPC on one CUDA card: the
condensed tick on the recorded stream, the port's bench, the segment
head-to-head, the full-space solver with debug-log mode and the condense
modes, the parallel axes (pipelined tick, row-sharded solve, multi-process
dry run), the host side (native runtime, real-time driver, telemetry, host
MuJoCo), the recorded streams against the float64 oracle and the tools,
the closed-loop flight and the Monte-Carlo sweep.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build     compile every CUDA kernel (one nvcc per source, started
             together) into build/torch_kernels/.
2. kernels   run each kernel against its plain PyTorch twin on the same
             CUDA tensors at the shapes its path gives it; time kernel,
             twin, the card's bound and, where one exists, a single PyTorch
             call that computes the same function. Every route a wrapper
             can choose (admm_segment: K⁻¹ in registers at P = 128, in the
             strips of a cluster at P = 256, spread over the card, a launch
             an iteration, at P = 1152 and 4224 — each segment row prints
             its route, cluster and kernels a call, and a NaN in one lane
             stays there on both new routes; woodbury_ns: one block or a
             cluster of 8 at P = 128, a cluster of 8 at P = 256) is held
             against the twin
             and timed as well, at batch 1, 64 and 256 (and the stock
             chunk and refresh at the sweep's batch, 1024), and woodbury_ns's
             general route (4 + 2·n_ns launches a call: the products over
             (scenario, output tile), the elimination on a cluster, a
             device scratch; each row prints its cluster, tile edge and
             device kernels) at the shapes the tuned routes do not take:
             P = 256 with n_box 132 (a control horizon of 13 with joint
             limits), P = 384, P = 640 and P = 1152 (above a block's 1024
             threads), each with torch.linalg.inv_ex beside it and held
             exactly symmetric; admm_segment's spread route also at
             P = 4224.
             The previous design's times stand beside the new ones, and the
             script fails where a kernel is more than 10 % slower than its
             previous design at a main-path shape, a P = 256, 1152 or 4224
             segment shape or any general-route shape, where a segment
             row at P >= 1152 is slower than its plain twin, or where
             woodbury_ns at n_box 120 (batch 256) or the
             general route at P = 256, n_box 132 (batch 1, n_ns 0 and 1)
             loses to torch.linalg.inv_ex. The grouped segment
             (group 1 to 16, one wave and four, P = 256) is also held
             against, and timed beside, the single-scenario kernel and the
             stock-PyTorch loop.
3. segments  the segment head-to-head entry point
             (tools/bench_segment_kernels_torch.main, batch 512 × 40
             iterations): three variants within 2e-3 of each other.
4. main      load the recorded flight stream on the card, configure, and
             chain 40 ticks at batch 256 (bench settings, batch-wide
             decisions, numpy-seeded lane jitter) and 40 ticks at batch 1
             (per-lane decisions), kernel_mode="auto"; every lane must
             solve, and the first 20 ticks must agree with the port's own
             CPU run (the plain twins) on the same inputs.
4b. bench    the port's bench (bench_torch.main, in-process) at
             BENCH_SCAN=40 and its other knobs' defaults: batch 256 chained
             over 40 recorded ticks three times, the per-dispatch loop,
             five batch-1 chains and the host round trips; its JSON line
             holds bench.py's keys and ``device``, every lane-tick solved,
             both kernels launched on both of its paths (their launches
             count in the kernels line). Printed as a ``[bench]`` line; its
             ~20-40 s come out of the batch-64 flight slice.
5. long_horizon  the recorded stream under MPCConfig(control_horizon=13,
             use_joint_position_constraint=True): nU = 132 pads to P = 256
             with the box over all 132 inputs, so the refresh takes
             woodbury_ns's general route; 10 ticks at batch 1 and 10 at
             batch 64, every lane solved, the first 5 against the port's
             CPU run, then 5 profiled: the refresh's and the segment's
             device ms and device kernels a tick.
5b. full_space  the recorded stream under MPCConfig(qp_solver="full")
             (588 variables, 512 rows, the default solver settings: 250
             iterations, ρ marks 25 / 75 / 150, polish): 20 ticks at batch
             1, one of them under set_sync_debug_mode("error"), and 10 at
             batch 64 with phase 4's jitter, every lane solved, no
             hand-written kernel launched, the first 5 ticks against the
             port's CPU run (batch 64 on its first 8 lanes), a profiled
             window (device ms, device kernels and torch.linalg calls a
             tick); debug-log mode under both solvers, 5 ticks at batch 1
             and 64 (finite, Ax within the bounds, the total the sum of the
             blocks, the solvers' block costs within 1e-2, against the CPU);
             the four condense modes at batch 256 on the first recorded
             tick against the sequential chain, each timed at batch 1 and
             256. Under 90 s.
5c. parallel  the parallel axes at full width: the four-stage pipelined
             tick (parallel.pipeline_tick, four CUDA streams of the one
             card) on the recorded stream at batch 256, 20 chained ticks
             against 20 monolithic per-lane ticks (statuses equal but
             SOLVED / SOLVED_INACCURATE flips within the 10x rule, commands,
             final state and carries within phase 4's batch-1 tolerances),
             both kernels launched in it, no host read-back, ms per tick
             both ways, a profiled window (device time summed and as a
             union of kernel intervals), the first 5 ticks against the
             port's CPU pipeline on 8 lanes, 2 debug-log ticks at batch 64;
             the row-sharded ADMM (parallel.solve_tp) over two gloo ranks
             sharing the card on the first recorded tick's full-space QP
             (588 variables x 512 rows) and on the dry run's 24 x 16 QP,
             against one rank on the card and on the CPU (x within 1e-5 of
             its largest entry), timed both ways; and
             parallel.dryrun_multichip(2) with its 16,384-lane sweep.
             Under 150 s.
5d. host_runtime  the host side: the native runtime library built by g++
             (native/ironcub_rt.cc) and its ring's concurrent stress
             (1024 × 8, 2e6 records); the real-time driver
             (examples/realtime_driver_torch.py, hover tick at batch 1) on
             the card: a 20-tick probe, 400 ticks paced at twice the probe's
             tick (at least 50 ms: every record solved, none dropped, at
             most 5 % overruns), 400 ticks at the reference's 5 ms (mean,
             p99, overruns and stalls reported, no bound), 10 profiled
             ticks (one host wait and one device-to-host copy a tick, both
             kernels launched); a device_trace of 2 ticks naming both
             kernels; solves_per_second of the batch-256 replay tick; 20
             closed-loop ticks saved to .mat and read back; where MuJoCo is
             installed, HostMujocoSim on the card (CoM within 1e-4 m of
             MuJoCo's, 40 closed-loop ticks solved) and compare_plants over
             300 ticks within tests/test_plant_divergence.py's bounds.
             Under 120 s.
6. flight    the closed loop at full width (23-joint calibrated Mk3 model,
             LSTM+EKF jets, mission trajectories, flight solver settings):
             batch 1 through ``run_flight`` (2 s settle, 400 ticks) with
             the per-layer split, a profiled window and a comparison of the
             first 20 ticks with the port's CPU run from the same settled
             state; batch 64 with batch-wide decisions and a numpy-seeded
             wind per lane over the first 20 s of the mission (4000 ticks,
             fewer if the time budget says so), ``flight_stats`` per lane
             and the flight-regression bounds on the wind-free lane 0.
6b. fidelity_tools  the float64-oracle mirror and the tools: both recorded
             flight streams (tests/golden/flight_snapshots*.npz, 120 ticks
             each, the flight configuration, 400 iterations, polish) through
             the tick on the card at batch 1 with the kernels on, against
             the float64 oracle of tests/golden_oracle.py on the host at
             tests/test_command_fidelity.py's tolerances (joints 2e-3 rad,
             throttle 0.15 %, thrust 0.5 N, thrust rate 2 N/s, throttle
             updates on the oracle's ticks, at least 5); then the main of
             every tool of tools/*_torch.py in-process at a small size (the
             four tick profilers at batch 64, the benches on short chains,
             the QP dump, the URDF writer, the snapshot recorder read back
             by runtime/replay.py, and the flight, 2 s unless phase 6's
             batch-1 ticks say the budget will not hold it: then fewer, with
             a warning), one summary line each, their kernels launched.
             Under 90 s.
7. sweep     the Monte-Carlo sweep (``parallel.run_sweep``) at full width:
             1024 scenarios, the size of one level of SWEEP_r05.json, wind
             σ = 5 N, recovery on, 200 ticks in chunks of 100 (fewer ticks,
             never fewer scenarios, if a 5-tick probe says they will not fit
             90 s), from the settled, configured carry of the mission start;
             the statistics' checks, read-backs and kernel launches per
             tick and the kernels' profiler time at B = 1024; then 16
             scenarios × 8 ticks resumed from a checkpoint after 4 against
             an uninterrupted run (counts equal, errors within 1e-6 m), and
             the same 16 × 8 through the port on the CPU, traced lane-tick
             by lane-tick: statuses equal but SOLVED / SOLVED_INACCURATE
             flips whose residuals agree within a factor 10, errors within
             1e-4 m.

``python3 chip_smoke.py --cards N`` runs only the parallel axes across N
cards: the pipelined tick with stage i on card i % N against the monolithic
tick on card 0, and dryrun_multichip(N) over nccl.

Launch counters are zeroed just before each path is driven and read just
after; every kernel of a path must have launched in it. Prints the card's
name and power limit, one JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``. The full record goes to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3
# bandwidth and float32 on CUDA cores (no tensor cores, no TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SIGMA, ALPHA = 1e-6, 1.6
P, NU, BOX0 = 128, 120, 96          # stock condensed layout, lane-padded
P2, NU2, BOX02 = 256, 240, 192      # twice the stock horizon
BENCH = dict(max_iter=40, polish=True, rho_update_iters=(15,),
             kinv_guard=True, ns_skip_tol=0.02, term_check_every=5,
             kernel_mode="auto")
N_TICKS, N_CHECK, BATCH = 40, 20, 256
# the bench phase: bench_torch.main at 40 chained ticks, its other knobs at
# their defaults; its line's keys are bench.py's (bench.py:232-243) and
# then "device"
BENCH_ENV = dict(BENCH_BATCH="256", BENCH_ITERS="10", BENCH_SCAN="40",
                 BENCH_EPS="1e-3", BENCH_STATIC="0", BENCH_MESH="0")
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "single_solve_p50_ms",
              "deadline_ms", "solved_frac", "per_dispatch_solves_per_s",
              "regime", "device"]
# a long horizon with joint limits: nU = 8·13 + 4·7 = 132 -> P = 256, n_box 132
LONG_HORIZON = dict(control_horizon=13, use_joint_position_constraint=True)
LH_TICKS, LH_CHECK, LH_BATCH, LH_PROFILED = 10, 5, 64, 5
# P = 1152 (nU = 1140), above the 1024 threads of a block: a box of 8 and
# of 132 (box0 = nU − n_box)
BIG_P, BIG_NU, BIG_BOX0S = 1152, 1140, (1132, 1008)
# the segments' spread route over the whole card (132 strips of 32 columns
# at batch 1): P = 4224, nU = 4200, a box of 132
WIDE_P, WIDE_NU, WIDE_BOX0 = 4224, 4200, 4068
# the head-to-head shape of the grouped segment, and the tick's chunk shape
SEG_BATCH, SEG_ITERS, GROUP = 512, 40, 8
# (batch, length, group, P, nU, box0) of the grouped rows: every group at
# the head-to-head shape, the tick's chunk at batch 1, 64 and 256 (beside
# admm_segment's 4 × 8 layout), four waves (B = 1056), P = 256, and
# P = 1152 with a box of 8 and of 132
GROUPED_SHAPES = [(SEG_BATCH, SEG_ITERS, g, P, NU, BOX0)
                  for g in (1, 4, 8, 16)] + [
    (1, 5, 1, P, NU, BOX0), (64, 5, 1, P, NU, BOX0),
    (BATCH, 5, GROUP, P, NU, BOX0), (1056, SEG_ITERS, GROUP, P, NU, BOX0),
    (64, 5, GROUP, P2, NU2, BOX02)] + [
    (1, 5, 1, BIG_P, BIG_NU, b0) for b0 in BIG_BOX0S]
# (P, nU, box0, batches, n_ns) of woodbury_ns's general route
WOODBURY_GENERAL = [(P2, 132, 0, (1, 64), (0, 1)), (384, 288, 208, (1,), (1,)),
                    (640, 528, 520, (1, 16), (1,)), (640, 528, 0, (1,), (0,))
                    ] + [(BIG_P, BIG_NU, b0, (1,), (0, 1)) for b0 in BIG_BOX0S]
# the full-space phase: 20 ticks at batch 1, 10 at batch 64, 5 of each
# against the CPU (batch 64 on its first 4 lanes), one tick profiled (the
# profiler's post-processing of a tick's 24,000-46,000 kernels takes
# seconds); debug-log mode 5 ticks at batch 1 and 64; the condense modes at
# batch 256
FS_TICKS_B1, FS_TICKS_BATCH, FS_BATCH, FS_CHECK = 20, 10, 64, 5
FS_CPU_LANES, FS_PROFILED, FS_DEBUG_TICKS = 4, 1, 5
FS_MODES_BATCH, FS_MODE_REPS, FS_BUDGET_S = 256, 20, 90.0
# the host side: the real-time driver's probe and paced runs (at twice the
# probe's tick, at least 50 ms, at most 5 % overruns; then the reference's
# 5 ms, unbounded), solves/s calls, telemetry ticks, the host-MuJoCo part's
# closed-loop and cross-engine ticks, and the phase's cap
RT_PROBE, RT_TICKS, RT_MIN_PERIOD_S, RT_REF_PERIOD_S = 20, 400, 0.05, 0.005
RT_OVERRUN_FRAC, RT_SYNC_TICKS, SPS_ITERS, TEL_TICKS = 0.05, 40, 10, 20
HM_TICKS, HM_COMPARE_TICKS, HOST_BUDGET_S = 40, 300, 120.0
# closed-loop flight: 2 s at batch 1; the first 20 s of the mission at batch
# 64 unless the whole script, the sweep phase after it included, would pass
# SCRIPT_BUDGET_S (620 s until the parallel phase came, before the flight,
# with its ~85 s; 700 s until the host_runtime phase came, also before the
# flight: its time comes out of the batch-64 slice, as does the budget of
# the fidelity_tools phase after it, so the script aims at about 600 s, half
# its 1200 s time limit)
FLIGHT_B1_S, FLIGHT_SETTLE_S = 2.0, 2.0
FLIGHT_BATCH, FLIGHT_SLICE_S, WIND_STD_N = 64, 20.0, 2.0
SCRIPT_BUDGET_S = 670.0
# the Monte-Carlo sweep: one level of SWEEP_r05.json at full width
SWEEP_SCEN, SWEEP_TICKS, SWEEP_CHUNK, SWEEP_BUDGET_S = 1024, 200, 100, 90.0
SWEEP_WIND_N, SWEEP_SEED = 5.0, 500      # the tool's seed int(w_std · 100)
RESUME_LANES, RESUME_TICKS = 16, 8

# Device ms of the previous designs of admm_segment (K⁻¹ in shared memory, one
# thread per coordinate) and woodbury_ns (intermediates in a device-memory
# scratch, one block of 4 × 4 register tiles per scenario), run H of PERF.md,
# of admm_segment_grouped (one block of 8 scenarios, 55 rows of each K⁻¹
# resident, the rest streamed from L2), run L, and of woodbury_ns's general
# route before its products were spread over the card and its elimination
# over a cluster (one block a scenario, 64 × 64 output tiles of 4 × 4 a
# thread, the elimination on one SM: PERF.md §6's rows of runs R, V and AJ),
# and of both segments' streamed and wide variants at P >= 256 (one block of
# at most 1024 threads a scenario re-reading K⁻¹ through L2 every
# iteration: PERF.md §6's run AK), from this script's phase 2 on PREVIOUS_CARD,
# keyed by batch; the new designs are held to them at the main path's
# shapes, the grouped kernel's timed shapes, every segment shape at P >= 256
# and every shape of the general route. Segments at P != 128 are keyed by
# (name, P, n_box).
PREVIOUS_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PREVIOUS_MS = {
    ("admm_segment", 5): {1: 0.0129, 64: 0.0132, 256: 0.0142},
    ("woodbury_ns", P, 24, 1): {1: 0.1836, 64: 0.1857, 256: 0.3095},
    ("woodbury_ns", P, 24, 0): {1: 0.0625, 64: 0.0634, 256: 0.0969},
    ("woodbury_ns", P, 120, 1): {256: 2.547},
    ("woodbury_ns", P2, 132, 0): {1: 1.0690, 64: 1.1631},
    ("woodbury_ns", P2, 132, 1): {1: 1.9107, 64: 2.2659},
    ("woodbury_ns", 384, 80, 1): {1: 3.4794},
    ("woodbury_ns", 640, 8, 1): {1: 13.0792, 16: 17.4215},
    ("woodbury_ns", 640, 528, 0): {1: 51.7684},
    ("woodbury_ns", BIG_P, 8, 0): {1: 2.9133},
    ("woodbury_ns", BIG_P, 8, 1): {1: 81.6738},
    ("woodbury_ns", BIG_P, 132, 0): {1: 8.7212},
    ("woodbury_ns", BIG_P, 132, 1): {1: 87.6901},
    ("admm_segment_grouped", 8): {512: 0.2628, 256: 0.0389},
    ("admm_segment", P2, NU2 - BOX02): {1: 0.0357, 64: 0.0375, 256: 0.1298},
    ("admm_segment", BIG_P, 8): {1: 0.3078},
    ("admm_segment", BIG_P, 132): {1: 0.3081},
    ("admm_segment", WIDE_P, 132): {1: 9.5192},
    ("admm_segment_grouped", P2, NU2 - BOX02): {64: 0.0376},
    ("admm_segment_grouped", BIG_P, 8): {1: 0.3091},
    ("admm_segment_grouped", BIG_P, 132): {1: 0.3094},
}
SLOWER_THAN_PREVIOUS = 1.10
# the long horizon's refresh at batch 1 must not lose to torch.linalg.inv_ex
LH_P, LH_NB = P2, 132


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(stop)


def cuda_ms(fn, reps=50, warmup=5):
    """Mean device time of ``fn()`` in ms from CUDA events around ``reps``
    back-to-back calls. A call's host work (allocation, checks, the ctypes
    call) can outlast a short kernel, so the stream is first held busy for
    twice the host time of the ``reps`` calls: the events then see the
    calls queued back to back and time the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if not hasattr(cuda_ms, "cycles_per_ms"):
        cuda_ms.cycles_per_ms = _sleep_cycles_per_ms()
    hold_ms = min(2.0 * reps * host_ms, 2000.0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * cuda_ms.cycles_per_ms))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def _spd(g, batch, n, dev):
    M = torch.randn(batch, n, n, generator=g, dtype=torch.float64)
    return (M @ M.mT / n + torch.eye(n, dtype=torch.float64)).to(dev)


def _kinv(H, rho_full, dev):
    K = H + SIGMA * torch.eye(H.shape[-1], dtype=H.dtype, device=dev) \
        + torch.diag_embed(rho_full)
    Ki = torch.linalg.inv(K)
    return (0.5 * (Ki + Ki.mT)).float()


def _pad(A, p):
    pad = p - A.shape[-1]
    return torch.nn.functional.pad(A, (0, pad, 0, pad)).contiguous()


def segment_inputs(batch, seed, dev, nu=NU, box0=BOX0, p=P):
    g = torch.Generator().manual_seed(seed)
    nb = nu - box0
    H = _spd(g, batch, nu, "cpu")
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    rho = rnd(batch, nb).abs() + 0.1
    rho_full = torch.zeros(batch, nu, dtype=torch.float64)
    rho_full[:, box0:] = rho.double()

    def full(v, fill=0.0):
        out = torch.full((batch, p), fill)
        out[:, nu:] = 0.0
        out[:, box0:nu] = v
        return out

    ins = dict(Kinv_p=_pad(_kinv(H, rho_full, "cpu"), p),
               q_f=full(torch.zeros(batch, nb)),
               lb_f=full(-rnd(batch, nb).abs(), -1e20),
               ub_f=full(rnd(batch, nb).abs(), 1e20),
               rho_f=full(rho), rhoi_f=full(1.0 / rho),
               x_f=torch.zeros(batch, p), z_f=full(rnd(batch, nb)),
               y_f=full(rnd(batch, nb)))
    ins["q_f"][:, :nu] = rnd(batch, nu)
    ins["x_f"][:, :nu] = rnd(batch, nu)
    return {k: v.contiguous().to(dev) for k, v in ins.items()}


def woodbury_inputs(batch, box0, seed, dev, nu=NU, p=P):
    g = torch.Generator().manual_seed(seed)
    nb = nu - box0
    H = _spd(g, batch, nu, "cpu")
    rho_old = torch.rand(batch, nb, generator=g, dtype=torch.float64) + 0.1
    rho_new = rho_old * (0.2 + 4.8 * torch.rand(batch, nb, generator=g,
                                                dtype=torch.float64))

    def full(v):
        out = torch.zeros(batch, p)
        out[:, box0:nu] = v.float()
        return out

    rf = torch.zeros(batch, nu, dtype=torch.float64)
    rf[:, box0:] = rho_old
    ins = dict(Kinv_p=_pad(_kinv(H, rf, "cpu"), p), H_p=_pad(H.float(), p),
               d_f=full(rho_new - rho_old), rho_f=full(rho_new))
    return {k: v.contiguous().to(dev) for k, v in ins.items()}


def segment_bound(batch, length, p=P):
    n_bytes = 4 * (batch * p * p + 8 * batch * p + 3 * batch * p)
    # per iteration: the P×P mat-vec (2P² operations) and ~12 elementwise
    # operations per coordinate
    n_ops = batch * length * (2 * p * p + 12 * p)
    return bound_ms(n_bytes, n_ops)


def woodbury_bound(batch, n_box, n_ns, p=P):
    # K⁻¹ in, the result out, d and ρ; H only where Newton–Schulz reads it
    n_bytes = 4 * batch * ((3 if n_ns else 2) * p * p + 2 * p)
    n = n_box
    # Gauss–Jordan in place 2n³ (n steps, each a multiply and a subtract on
    # n × n entries), W = M⁻¹(d⊙K⁻¹[box,:]) 2n²P, the rank-n update 2P²n,
    # two P³ products per Newton–Schulz step, the symmetrisation
    n_ops = batch * (2 * n ** 3 + 2 * n * n * p + 2 * p * p * n
                     + n_ns * 4 * p ** 3 + 2 * p * p)
    return bound_ms(n_bytes, n_ops)


def _previous(row):
    """The previous design's ms at this row's shape, where it was timed."""
    if row["name"] == "woodbury_ns":
        key = ("woodbury_ns", row["P"], row["n_box"], row["n_ns"])
    elif row["P"] != P:
        key = (row["name"], row["P"], row["n_box"])
    elif row["name"] == "admm_segment":
        key = ("admm_segment", row["length"])
    else:
        key = ("admm_segment_grouped", row["group"])
    return PREVIOUS_MS.get(key, {}).get(row["batch"])


def segment_route(plan):
    """A segment row's route, cluster, place of K⁻¹ and kernels a call."""
    return dict(route=plan["route"], cluster=plan["cluster"],
                kinv="registers" if plan["kinv_in_registers"] else
                "shared" if plan["route"] == "cluster" else
                f"streamed in strips of {plan['spread_cols']}",
                kernels=plan["kernels"])


def segment_nan_lane(K, dev):
    """A NaN in one lane's x stays in that lane on the cluster route
    (P = 256, batch 64) and the spread route (P = 1152, batch 2) of both
    segment wrappers; the other lanes match the twin within 1e-4."""
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5)
    for batch, nu, box0, p in ((FLIGHT_BATCH, NU2, BOX02, P2),
                               (2, BIG_NU, BIG_BOX0S[1], BIG_P)):
        ins = list(segment_inputs(batch, 60 + batch, dev, nu, box0,
                                  p).values())
        ins[6][1, 5] = float("nan")
        route = K.segment_plan(batch, p, 5)["route"]
        ref = K.admm_segment_plain(*ins, **kw)
        for name, got in (("admm_segment", K.admm_segment(*ins, **kw)),
                          ("admm_segment_grouped", K.admm_segment_grouped(
                              *ins, group=1, **kw))):
            torch.cuda.synchronize()
            keep = torch.arange(batch, device=dev) != 1
            for g, r in zip(got, ref):
                check(torch.equal(g.isnan(), r.isnan())
                      and bool(g[1, :nu].isnan().all())
                      and float((g[keep] - r[keep]).abs().max()) <= 1e-4,
                      f"{name} {route} P={p} B={batch}: the NaN lane "
                      "leaked or the other lanes left the twin")
        print(f"[kernels] {route} route, P={p} B={batch}: a NaN in lane 1 "
              f"stays there in both segment wrappers")


def segment_row(K, ins, batch, length, p=P, n_box=NU - BOX0):
    """One admm_segment row: the kernel against the twin, its time and its
    bound."""
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=length)
    got = K.admm_segment(*ins, **kw)
    ref = K.admm_segment_plain(*ins, **kw)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    tol = 1e-4
    plan = K.segment_plan(batch, p, length)
    ok = all(bool(torch.isfinite(a).all()) for a in got)
    check(ok and err <= tol, f"admm_segment B={batch} P={p} L={length} "
          f"{plan['route']}: err {err:.3e} > {tol}")
    bms, by = segment_bound(batch, length, p)
    return dict(
        name="admm_segment", batch=batch, length=length, P=p, n_box=n_box,
        **segment_route(plan), forced=False, max_abs_err=err, tol=tol,
        ms=cuda_ms(lambda: K.admm_segment(*ins, **kw)),
        plain_ms=cuda_ms(lambda: K.admm_segment_plain(*ins, **kw), reps=10),
        bound_ms=bms, bound_by=by, library_ms=None)


def woodbury_row(K, ins, batch, box0, nb, n_ns, cluster=None, ref=None,
                 tol=1e-4):
    """One woodbury_ns row: the kernel on a cluster of ``cluster`` blocks
    (or the plan's choice) against the twin ``ref``, its time and bound."""
    p = ins[0].shape[-1]
    kw = dict(box0=box0, n_box=nb, sigma=SIGMA, n_ns=n_ns)
    got = K.woodbury_ns(*ins, cluster=cluster, **kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    plan = K.woodbury_plan(batch, p, nb, n_ns, cluster)
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"woodbury_ns B={batch} P={p} box0={box0} n_ns={n_ns} "
          f"{plan['route']} cluster={plan['cluster']}: err {err:.3e} > {tol}")
    if plan["route"] == "general":
        check(torch.equal(got, got.mT),
              f"woodbury_ns B={batch} P={p} box0={box0} n_ns={n_ns} general: "
              "the output is not exactly symmetric")
    bms, by = woodbury_bound(batch, nb, n_ns, p)
    return dict(
        name="woodbury_ns", batch=batch, P=p, box0=box0, n_box=nb, n_ns=n_ns,
        route=plan["route"], cluster=plan["cluster"],
        tile=plan.get("tile", "none"), kernels=plan.get("kernels", 1),
        forced=cluster is not None, max_abs_err=err, tol=tol,
        ms=cuda_ms(lambda: K.woodbury_ns(*ins, cluster=cluster, **kw)),
        plain_ms=None, bound_ms=bms, bound_by=by, library_ms=None)


def phase_kernels(K, dev, record):
    t_phase = time.perf_counter()
    rows = []
    # batch 1 and FLIGHT_BATCH are the closed loop's shapes, BATCH the
    # replay's; (P, NU, BOX0) is the stock layout, (P2, NU2, BOX02) twice the
    # stock horizon, where the segment streams K⁻¹ and the refresh needs a
    # cluster
    for batch in (1, FLIGHT_BATCH, BATCH):
        ins = list(segment_inputs(batch, 10 + batch, dev).values())
        for length in (5, 15):
            rows.append(segment_row(K, ins, batch, length))
        ins = list(segment_inputs(batch, 40 + batch, dev, NU2, BOX02,
                                  P2).values())
        rows.append(segment_row(K, ins, batch, 5, p=P2, n_box=NU2 - BOX02))
    # the sweep's shape: 1024 scenarios, the tick's chunk of 5
    ins = list(segment_inputs(SWEEP_SCEN, 10 + SWEEP_SCEN, dev).values())
    rows.append(segment_row(K, ins, SWEEP_SCEN, 5))
    # above a block's 1024 threads: two coordinates a thread
    for box0 in BIG_BOX0S:
        ins = list(segment_inputs(1, 50, dev, BIG_NU, box0, BIG_P).values())
        rows.append(segment_row(K, ins, 1, 5, p=BIG_P, n_box=BIG_NU - box0))
    ins = list(segment_inputs(1, 51, dev, WIDE_NU, WIDE_BOX0, WIDE_P).values())
    rows.append(segment_row(K, ins, 1, 5, p=WIDE_P, n_box=WIDE_NU - WIDE_BOX0))
    tuned = [(p, nu, box0, (1, FLIGHT_BATCH, BATCH), (0, 1))
             for p, nu, box0 in ((P, NU, BOX0), (P, NU, 0), (P2, NU2, BOX02))]
    # the sweep's refresh (n_ns 1) and polish operator (n_ns 0)
    tuned.append((P, NU, BOX0, (SWEEP_SCEN,), (0, 1)))
    for p, nu, box0, batches, ns_steps in tuned + WOODBURY_GENERAL:
        for batch in batches:
            ins = list(woodbury_inputs(batch, box0, 20 + box0 + batch, dev,
                                       nu, p).values())
            nb = nu - box0
            K_new = (ins[1][:, :nu, :nu] + SIGMA * torch.eye(nu, device=dev)
                     + torch.diag_embed(ins[3][:, :nu])).contiguous()
            for n_ns in ns_steps:
                kw = dict(box0=box0, n_box=nb, sigma=SIGMA, n_ns=n_ns)
                ref = K.woodbury_ns_plain(*ins, **kw)
                general = K.woodbury_plan(batch, p, nb, n_ns)["route"] \
                    == "general"
                row = woodbury_row(K, ins, batch, box0, nb, n_ns, ref=ref,
                                   tol=1e-5 if general else 1e-4)
                row["plain_ms"] = cuda_ms(
                    lambda: K.woodbury_ns_plain(*ins, **kw), reps=10)
                # the batched inverse of K(ρ_new) computes the same
                # function; timed here as a yardstick only (inv_ex: inv
                # would read its error flag back on the host)
                row["library_ms"] = cuda_ms(
                    lambda: torch.linalg.inv_ex(K_new), reps=10)
                rows.append(row)
                # the cluster size the plan did not choose
                for c in K.WOODBURY_CLUSTERS.get(p, ()) if not general \
                        else ():
                    if c != row["cluster"]:
                        rows.append(woodbury_row(K, ins, batch, box0, nb,
                                                 n_ns, cluster=c, ref=ref))
    rows += grouped_rows(K, dev)
    slow = []
    for r in rows:
        shape = ", ".join(f"{k}={r[k]}" for k in
                          ("batch", "length", "group", "P", "route", "box0",
                           "n_box", "n_ns", "cluster", "kinv", "tile",
                           "kernels") if k in r)
        opt = lambda v: "none" if v is None else f"{v:.4f}"  # noqa: E731
        line = (f"[kernels] {r['name']}({shape}): err {r['max_abs_err']:.2e} "
                f"(tol {r['tol']:.0e})  kernel {r['ms']:.4f} ms  twin "
                f"{opt(r['plain_ms'])} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})  library {opt(r['library_ms'])} ms")
        prev = None if r.get("forced", True) else _previous(r)
        if prev is not None:
            r["previous_ms"] = prev
            line += f"  previous design {prev:.4f} ms ({PREVIOUS_CARD})"
            main_path = (r["name"] != "woodbury_ns"
                         or r["n_box"] == NU - BOX0
                         or r["route"] == "general")
            if main_path and r["ms"] > SLOWER_THAN_PREVIOUS * prev:
                slow.append(f"{r['name']}({shape}) {r['ms']:.4f} ms against "
                            f"{prev:.4f} ms")
        print(line)
        if "single_ms" in r:
            print(f"[kernels]   same shape: admm_segment "
                  f"{r['single_ms']:.4f} ms, torch-bmm loop "
                  f"{r['bmm_ms']:.4f} ms; err vs admm_segment "
                  f"{r['err_vs_single']:.2e}")
    check(not slow, "slower than the previous design by more than 10 %: "
          + "; ".join(slow))
    # the spread route must not lose to the plain twin, whose batched
    # products re-read K⁻¹ from device memory every iteration
    losing = [f"{r['name']} P={r['P']} n_box={r['n_box']} B={r['batch']}: "
              f"{r['ms']:.4f} ms against {r['plain_ms']:.4f}"
              for r in rows if r["name"] != "woodbury_ns"
              and r["P"] >= BIG_P and r["ms"] > r["plain_ms"]]
    check(not losing, "segments at P >= 1152 slower than their plain twin: "
          + "; ".join(losing))
    segment_nan_lane(K, dev)
    wide = next(r for r in rows if r["name"] == "woodbury_ns"
                and not r["forced"] and r["batch"] == BATCH and r["P"] == P
                and r["n_box"] == NU and r["n_ns"] == 1)
    check(wide["ms"] <= wide["library_ms"],
          f"woodbury_ns at n_box {NU}, batch {BATCH}: {wide['ms']:.4f} ms "
          f"loses to torch.linalg.inv_ex, {wide['library_ms']:.4f} ms")
    for r in rows:
        if r["name"] == "woodbury_ns" and r["route"] == "general" \
                and (r["P"], r["n_box"], r["batch"]) == (LH_P, LH_NB, 1):
            check(r["ms"] <= r["library_ms"],
                  f"woodbury_ns general at P {LH_P}, n_box {LH_NB}, batch 1, "
                  f"n_ns {r['n_ns']}: {r['ms']:.4f} ms loses to "
                  f"torch.linalg.inv_ex, {r['library_ms']:.4f} ms")
    record["kernels"] = rows
    record["kernels_phase_s"] = time.perf_counter() - t_phase
    print(f"[kernels] the phase took {record['kernels_phase_s']:.1f} s")
    return rows


def segment_tool():
    """tools/bench_segment_kernels_torch.py as a module."""
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import bench_segment_kernels_torch

    return bench_segment_kernels_torch


def grouped_rows(K, dev):
    """admm_segment_grouped against its twin and against admm_segment at
    GROUPED_SHAPES."""
    bmm_segment = segment_tool().torch_bmm_segment
    rows = []
    for batch, length, group, p, nu, box0 in GROUPED_SHAPES:
        ins = segment_inputs(batch, 30 + batch, dev, nu, box0, p)
        kw = dict(sigma=SIGMA, alpha=ALPHA, length=length)
        got = K.admm_segment_grouped(*ins.values(), group=group, **kw)
        ref = K.admm_segment_grouped_plain(*ins.values(), group=group, **kw)
        one = K.admm_segment(*ins.values(), **kw)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        err1 = max(float((a - b).abs().max()) for a, b in zip(got, one))
        tol = 1e-4
        ok = all(bool(torch.isfinite(a).all()) for a in got)
        plan = K.grouped_plan(batch, p, group, length)
        check(ok and err <= tol and err1 <= tol,
              f"admm_segment_grouped B={batch} L={length} G={group} P={p} "
              f"{plan['route']}: err {err:.3e} (twin), {err1:.3e} "
              f"(admm_segment) > {tol}")
        bms, by = segment_bound(batch, length, p)
        rows.append(dict(
            name="admm_segment_grouped", batch=batch, length=length,
            group=group, P=p, n_box=nu - box0, **segment_route(plan),
            forced=False,
            max_abs_err=err,
            err_vs_single=err1, tol=tol,
            ms=cuda_ms(lambda: K.admm_segment_grouped(
                *ins.values(), group=group, **kw)),
            plain_ms=cuda_ms(lambda: K.admm_segment_grouped_plain(
                *ins.values(), group=group, **kw), reps=10),
            single_ms=cuda_ms(lambda: K.admm_segment(*ins.values(), **kw)),
            bmm_ms=cuda_ms(lambda: bmm_segment(*ins.values(), **kw),
                           reps=10),
            bound_ms=bms, bound_by=by, library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the segment head-to-head (path A)
# ---------------------------------------------------------------------------


def phase_segments(K, record):
    K.reset_launches()
    res = segment_tool().main(SEG_BATCH, SEG_ITERS)
    torch.cuda.synchronize()
    launches = {"admm_segment": K.admm_segment.launches,
                "admm_segment_grouped": K.admm_segment_grouped.launches}
    for k, n in launches.items():
        check(n > 0, f"segments: {k} was never launched")
    check(K.woodbury_ns.launches == 0, "segments: woodbury_ns launched")
    for name, err in res["err"].items():
        check(err < 2e-3, f"segments: {name} err {err:.3e} >= 2e-3")
    res["launches"] = launches
    print(f"[segments] launches {launches}, max err vs torch-bmm "
          f"{res['err']}")
    record["segments"] = res
    return res


# ---------------------------------------------------------------------------
# phase 4: the condensed tick on the recorded stream (replay path)
# ---------------------------------------------------------------------------


def read_launches(K):
    return {"admm_segment": K.admm_segment.launches,
            "woodbury_ns": K.woodbury_ns.launches}


def run_ticks(mpc, replay, problem, carry, settings, batch, n_ticks, jitter,
              per_tick_sync=False, sync_check_tick=None, tick=None):
    """Chain ``n_ticks`` replay ticks of ``tick`` (``mpc.mpc_tick`` unless
    given); returns (carry, outputs on the host, per-tick host times in
    ms). An output's DebugInfo comes along when the config emits one.
    ``sync_check_tick`` runs that tick under ``set_sync_debug_mode("error")``:
    any call that waits for the device raises."""
    from ironcub_mpc_tpu_torch.core.types import expand_lanes

    dev = replay.est_td.device
    jit = None if jitter is None else torch.as_tensor(jitter, device=dev)
    c = expand_lanes(carry, batch)
    tick = tick or mpc.mpc_tick
    outs, times = [], []
    for t in range(n_ticks):
        snap, est = replay.tick_inputs(t, batch, jit)
        if t == sync_check_tick:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            c, out = tick(replay.cfg, replay.sched, replay.sel, settings,
                          problem, c, snap, est)
        finally:
            if t == sync_check_tick:
                torch.cuda.set_sync_debug_mode("default")
        if per_tick_sync:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        outs.append(out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    host = []
    for o in outs:
        h = {k: getattr(o, k).cpu().numpy() for k in
             ("joints_pos_ref", "throttle", "thrust_des", "final_state",
              "status", "guard_fired", "pri_res", "dua_res")}
        if o.debug is not None:
            h["debug"] = {k: v.cpu().numpy()
                          for k, v in o.debug._asdict().items()}
        host.append(h)
    return c, host, times


def compare_streams(gpu, cpu, tol, what):
    """The card's ticks against the CPU's: statuses and guard flags equal,
    commands and final state within ``tol`` (final_state relative to its
    largest entry), a DebugInfo within 1e-4 of each field's largest
    entry."""
    worst = {k: 0.0 for k in tol}
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        check(np.array_equal(g["status"], c["status"]),
              f"{what} tick {t}: status differs from the CPU run")
        check(np.array_equal(g["guard_fired"], c["guard_fired"]),
              f"{what} tick {t}: guard_fired differs from the CPU run")
        for k, lim in tol.items():
            err = float(np.abs(g[k] - c[k]).max())
            if k == "final_state":
                err /= max(float(np.abs(c[k]).max()), 1.0)
            worst[k] = max(worst[k], err)
            check(err <= lim, f"{what} tick {t}: {k} err {err:.3e} > {lim}")
        for k, v in g.get("debug", {}).items():
            ref = c["debug"][k]
            err = float(np.abs(v - ref).max()) / max(
                float(np.abs(ref).max()), 1.0)
            worst[f"debug.{k}"] = max(worst.get(f"debug.{k}", 0.0), err)
            check(err <= 1e-4, f"{what} tick {t}: debug {k} err {err:.3e}")
    return worst


def phase_main(K, dev, record):
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    jitter = (0.1 * np.random.default_rng(0).standard_normal((BATCH, 6))
              ).astype(np.float32)
    # tolerances of tests/test_torch_tick.py: batch 1 as its batch-1 tick
    # test; the batch-256 run as its batch-4 test, whose looser throttle and
    # final_state bounds carry the reason (the batched solve's adaptive-ρ
    # ratio is sensitive at float32 rounding, and the card sums in other
    # orders than the CPU)
    tight = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
                 final_state=2e-5)
    loose = dict(tight, throttle=0.1, final_state=1e-2)
    runs = {
        f"batch{BATCH}": (BATCH, admm.ADMMSettings(**BENCH, batch_guard=True),
                          jitter, loose),
        "batch1": (1, admm.ADMMSettings(**BENCH), None, tight),
    }
    replay = load_flight_replay(device=dev)
    replay_cpu = load_flight_replay(device="cpu")
    check(replay.n_ticks >= N_TICKS, "replay stream too short")
    out = {}
    for name, (batch, settings, jit, tol) in runs.items():
        problem, carry = replay.configure(settings)
        # warm-up: first launches, cuBLAS handles, the allocator
        run_ticks(mpc, replay, problem, carry, settings, batch, 3, jit)
        K.reset_launches()
        condensed.batch_any.syncs = 0
        t0 = time.perf_counter()
        _, gpu, times = run_ticks(mpc, replay, problem, carry, settings,
                                  batch, N_TICKS, jit,
                                  per_tick_sync=(batch == 1))
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = read_launches(K)
        syncs = condensed.batch_any.syncs
        for k, n in launches.items():
            check(n > 0, f"{name}: {k} was never launched on the main path")
        status = np.stack([o["status"] for o in gpu])
        solved = float(np.isin(status, (admm.SOLVED,
                                        admm.SOLVED_INACCURATE)).mean())
        for o in gpu:
            for k in ("joints_pos_ref", "throttle", "final_state"):
                check(np.isfinite(o[k]).all(), f"{name}: non-finite {k}")
        check(gpu[0]["final_state"].shape == (batch, 26),
              f"{name}: final_state shape {gpu[0]['final_state'].shape}")
        print(f"[main] {name}: solved fraction {solved}")
        check(solved == 1.0, f"{name}: solved fraction {solved} < 1.0")

        # the same ticks through the plain twins on the CPU
        problem_c, carry_c = replay_cpu.configure(settings)
        _, cpu, _ = run_ticks(mpc, replay_cpu, problem_c, carry_c, settings,
                              batch, N_CHECK, jit)
        worst = compare_streams(gpu[:N_CHECK], cpu, tol, name)

        # device time by kernel over a short steady window
        prof = profile_window(lambda n: run_ticks(
            mpc, replay, problem, carry, settings, batch, n, jit))
        ms_tick = wall_ms / N_TICKS
        res = dict(batch=batch, ticks=N_TICKS, ms_per_tick=ms_tick,
                   solves_per_s=1e3 * batch / ms_tick,
                   tick_ms_p50=float(np.median(times)),
                   tick_ms_max=float(np.max(times)),
                   host_syncs_per_tick=syncs / N_TICKS,
                   launches=launches,
                   launches_per_tick={k: n / N_TICKS
                                      for k, n in launches.items()},
                   solved_frac=solved, max_err_vs_cpu=worst,
                   status_counts={int(s): int((status == s).sum())
                                  for s in np.unique(status)},
                   profile=prof)
        out[name] = res
        print(f"[main] {name}: {ms_tick:.3f} ms/tick "
              f"({res['solves_per_s']:.1f} solves/s), per-tick p50 "
              f"{res['tick_ms_p50']:.3f} ms (5 ms deadline), host syncs/tick "
              f"{res['host_syncs_per_tick']:.2f}, launches {launches}, "
              f"max err vs CPU {worst}")
        for k, v in prof["kernels"].items():
            print(f"[main] {name}: {k}: {v['calls']} launches, mean "
                  f"{v['mean_ms']:.4f} ms (profiler, {prof['ticks']} ticks)")
        print(f"[main] {name}: profiled {prof['ticks']} ticks: device busy "
              f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.3f} ms wall, "
              f"{prof['device_kernels_per_tick']:.1f} device kernels/tick")
    record["main"] = out
    return out


# ---------------------------------------------------------------------------
# phase 4b: the port's bench
# ---------------------------------------------------------------------------


def phase_bench(record):
    """bench_torch.main in-process at BENCH_ENV: one JSON line with
    bench.py's keys and ``device``, every lane-tick solved, both kernels
    launched on both paths (the bench zeroes the counts before each path's
    timed chains and reads them after). Returns the two paths' launches."""
    import contextlib
    import io
    from unittest import mock

    import bench_torch

    t0 = time.perf_counter()
    stdout = io.StringIO()
    with mock.patch.dict(os.environ, BENCH_ENV), \
            contextlib.redirect_stdout(stdout):
        line, detail = bench_torch.main([])
    phase_s = time.perf_counter() - t0
    printed = [json.loads(x) for x in stdout.getvalue().splitlines()
               if x.startswith("{")]
    check(printed == [line], f"bench: printed {stdout.getvalue()!r}")
    check(list(line) == BENCH_KEYS, f"bench: keys {list(line)}")
    check(line["solved_frac"] == 1.0
          and detail["latency"]["solved_frac"] == 1.0,
          f"bench: solved fraction {line['solved_frac']} / "
          f"{detail['latency']['solved_frac']} < 1.0")
    for k, v in line.items():
        if isinstance(v, float):
            check(np.isfinite(v) and v > 0, f"bench: {k} = {v}")
    paths = {name: dict(launches=detail[name]["launches"])
             for name in ("throughput", "latency")}
    for name, path in paths.items():
        for k, n in path["launches"].items():
            check(n > 0, f"bench: {k} was never launched on the {name} path")
    print(f"[bench] {json.dumps(line)}")
    print(f"[bench] the phase took {phase_s:.1f} s; launches "
          f"{paths['throughput']['launches']} (batch 256, 3 x "
          f"{BENCH_ENV['BENCH_SCAN']} ticks) / {paths['latency']['launches']} "
          f"(batch 1, 5 x {BENCH_ENV['BENCH_SCAN']}); host read-backs a tick "
          f"{detail['throughput']['syncs_per_tick']:.2f} / "
          f"{detail['latency']['syncs_per_tick']:.2f}; host round trip p50 "
          f"{detail['latency']['round_trip_p50_ms']:.3f} ms")
    record["bench"] = dict(line=line, detail=detail, phase_s=phase_s)
    return paths


# ---------------------------------------------------------------------------
# phase 5: a long horizon with joint limits on the recorded stream
# ---------------------------------------------------------------------------


def long_horizon_replay(device):
    """The recorded stream configured at LONG_HORIZON (the stream carries
    snapshots, not a horizon: the reference windows are cut to the new
    one)."""
    from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    replay = load_flight_replay(device=device)
    cfg = dataclasses.replace(replay.cfg, **LONG_HORIZON)
    return replay._replace(cfg=cfg, sched=build_schedule(cfg))


def phase_long_horizon(K, dev, record):
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc

    replay = long_horizon_replay(dev)
    replay_cpu = long_horizon_replay("cpu")
    nu, nb = condensed.n_inputs(replay.cfg), condensed.n_box(replay.cfg)
    p = K._pad_to(nu)
    check(K.woodbury_plan(1, p, nb, 1)["route"] == "general",
          f"long_horizon: nU {nu}, n_box {nb} does not take the general "
          "route")
    jitter = (0.1 * np.random.default_rng(1).standard_normal((LH_BATCH, 6))
              ).astype(np.float32)
    # batch 1 at the tolerances of tests/test_torch_tick.py's joint-limits
    # tick, as phase 4's batch 1; batch 64 with batch-wide decisions at those
    # of phase 4's batched run, for the reason given there
    tight = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
                 final_state=2e-5)
    loose = dict(tight, throttle=0.1, final_state=1e-2)
    runs = {"batch1": (1, admm.ADMMSettings(**BENCH), None, tight),
            f"batch{LH_BATCH}": (LH_BATCH,
                                 admm.ADMMSettings(**BENCH, batch_guard=True),
                                 jitter, loose)}
    out = {}
    for name, (batch, settings, jit, tol) in runs.items():
        problem, carry = replay.configure(settings)
        K.reset_launches()
        t0 = time.perf_counter()
        _, gpu, _ = run_ticks(mpc, replay, problem, carry, settings, batch,
                              LH_TICKS, jit)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = read_launches(K)
        for k, n in launches.items():
            check(n > 0, f"long_horizon {name}: {k} was never launched")
        status = np.stack([o["status"] for o in gpu])
        solved = float(np.isin(status, (admm.SOLVED,
                                        admm.SOLVED_INACCURATE)).mean())
        for o in gpu:
            for k in ("joints_pos_ref", "throttle", "final_state"):
                check(np.isfinite(o[k]).all(),
                      f"long_horizon {name}: non-finite {k}")
        check(solved == 1.0, f"long_horizon {name}: solved fraction {solved}")
        problem_c, carry_c = replay_cpu.configure(settings)
        _, cpu, _ = run_ticks(mpc, replay_cpu, problem_c, carry_c, settings,
                              batch, LH_CHECK, jit)
        worst = compare_streams(gpu[:LH_CHECK], cpu, tol,
                                f"long_horizon {name}")
        # the refresh's device time and device kernels a tick (the general
        # route launches 4 + 2·n_ns kernels a call)
        prof = profile_window(lambda n: run_ticks(
            mpc, replay, problem, carry, settings, batch, n, jit),
            n=LH_PROFILED)
        refresh = prof["kernels"].get("woodbury_ns")
        segment = prof["kernels"].get("admm_segment")
        check(refresh is not None and segment is not None,
              f"long_horizon {name}: no woodbury_ns or admm_segment kernel "
              "in the profile")
        out[name] = dict(batch=batch, ticks=LH_TICKS, nU=nu, P=p, n_box=nb,
                         ms_per_tick_first_included=wall_ms / LH_TICKS,
                         launches=launches, solved_frac=solved,
                         max_err_vs_cpu=worst,
                         refresh_device_ms_per_tick=refresh["total_ms"]
                         / prof["ticks"],
                         refresh_kernels_per_tick=refresh["calls"]
                         / prof["ticks"],
                         segment_device_ms_per_tick=segment["total_ms"]
                         / prof["ticks"],
                         segment_kernels_per_tick=segment["calls"]
                         / prof["ticks"],
                         segment_plan=segment_route(
                             K.segment_plan(batch, p, BENCH[
                                 "term_check_every"])),
                         profile=prof)
        print(f"[long_horizon] {name}: nU {nu} (P {p}, n_box {nb}), "
              f"{LH_TICKS} ticks, solved fraction {solved}, launches "
              f"{launches}, {wall_ms / LH_TICKS:.3f} ms/tick (first tick "
              f"included), max err vs CPU over {LH_CHECK} ticks {worst}")
        print(f"[long_horizon] {name}: profiled {prof['ticks']} ticks: "
              f"woodbury_ns {out[name]['refresh_device_ms_per_tick']:.4f} "
              f"device ms and {out[name]['refresh_kernels_per_tick']:.1f} "
              f"device kernels a tick (mean {refresh['mean_ms']:.4f} ms a "
              f"kernel); admm_segment "
              f"{out[name]['segment_device_ms_per_tick']:.4f} device ms and "
              f"{out[name]['segment_kernels_per_tick']:.1f} device kernels a "
              f"tick (mean {segment['mean_ms']:.4f} ms a kernel, "
              f"{out[name]['segment_plan']}); device busy "
              f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.3f} ms wall, "
              f"{prof['device_kernels_per_tick']:.1f} device kernels a tick")
    record["long_horizon"] = out
    return out


def profile_window(run, n=10):
    """torch.profiler over ``run(n)``, which drives ``n`` ticks: the device's
    busy time and kernel count (every event that ran on the card), the two
    kernels' device time, the ``torch.linalg`` calls, the host calls that
    wait for the device, and the heaviest device kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
        # the window's wall ends here: the profiler's own post-processing on
        # leaving the block takes seconds
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_card = [ev for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in on_card)
    # a wrapper's launches, over every instantiation of its kernel
    ours = {}
    for ev in on_card:
        for name, marks in (("admm_segment", ("admm_segment_reg_kernel",
                                              "admm_segment_cluster_kernel",
                                              "admm_segment_spread_kernel")),
                            ("woodbury_ns", ("woodbury_ns_kernel",
                                             "woodbury_ns_general_"))):
            if any(m in ev.key for m in marks):
                k = ours.setdefault(name, dict(calls=0, total_ms=0.0))
                k["calls"] += ev.count
                k["total_ms"] += ev.self_device_time_total / 1e3
    for k in ours.values():
        k["mean_ms"] = k["total_ms"] / k["calls"]
    waits = {ev.key: ev.count for ev in events
             if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "aten::item", "cudaMemcpyAsync")}
    # the copies on the card, by direction and kind of host memory
    copies = {ev.key: ev.count for ev in on_card
              if ev.key.startswith("Memcpy")}
    top_dev = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    top_host = sorted((ev for ev in events
                       if ev.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:8]
    # the union of the kernels' intervals on the card's clock: below the
    # sum of their times where kernels of several streams overlap
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    union_us, reach = 0.0, -float("inf")
    for start, end in spans:
        union_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return dict(
        ticks=n, wall_ms=wall,
        device_busy_ms=busy_us / 1e3 if on_card else "not measured",
        device_busy_share=(busy_us / 1e3 / wall if on_card
                           else "not measured"),
        device_union_ms=union_us / 1e3 if spans else "not measured",
        device_kernels_per_tick=sum(ev.count for ev in on_card) / n,
        linalg_calls_per_tick=sum(ev.count for ev in events
                                  if ev.key.startswith("aten::linalg_")) / n,
        kernels=ours, host_waits=waits, copies=copies,
        top_device=[(ev.key[:60], ev.count, ev.self_device_time_total / 1e3)
                    for ev in top_dev],
        top_host=[(ev.key[:60], ev.count, ev.self_cpu_time_total / 1e3)
                  for ev in top_host])


# ---------------------------------------------------------------------------
# phase 5b: the full-space solver, debug-log mode and the condense modes
# ---------------------------------------------------------------------------


def full_replay(device, **over):
    """The recorded stream under ``over`` (a solver, the debug flag, a
    condense mode)."""
    from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    replay = load_flight_replay(device=device)
    cfg = dataclasses.replace(replay.cfg, **over)
    return replay._replace(cfg=cfg, sched=build_schedule(cfg))


def lanes_of(outs, n):
    """The first ``n`` lanes of host outputs."""
    return [{k: ({dk: dv[:n] for dk, dv in v.items()} if k == "debug"
                 else v[:n]) for k, v in o.items()} for o in outs]


def check_solved(outs, what):
    status = np.stack([o["status"] for o in outs])
    check(np.isin(status, (1, 2)).all(),
          f"{what}: statuses {np.unique(status).tolist()}, not all solved")
    for o in outs:
        for k in ("joints_pos_ref", "throttle", "final_state"):
            check(np.isfinite(o[k]).all(), f"{what}: non-finite {k}")
    return {int(v): int((status == v).sum()) for v in np.unique(status)}


def check_debug(outs, what):
    """DebugInfo of every lane and tick: finite, Ax within the bounds at
    5e-3·max(|lb|, 1), the total the sum of the blocks (rtol 1e-6)."""
    for t, o in enumerate(outs):
        d = o["debug"]
        for k, v in d.items():
            check(np.isfinite(v).all(), f"{what} tick {t}: non-finite {k}")
        ax, lb, ub = (d[k].astype(np.float64) for k in
                      ("constraint_ax", "constraint_lb", "constraint_ub"))
        scale = np.maximum(np.abs(lb), 1.0)
        check(bool((ax >= lb - 5e-3 * scale).all()
                   and (ax <= ub + 5e-3 * scale).all()),
              f"{what} tick {t}: Ax outside [lb, ub]")
        np.testing.assert_allclose(d["total_cost"],
                                   d["block_costs"].sum(-1), rtol=1e-6,
                                   err_msg=f"{what} tick {t}: total_cost")


def phase_full_space(K, dev, record):
    """(a) the full-space tick (qp_solver="full", 588 variables, 512 rows,
    the default settings: 250 iterations, ρ marks 25 / 75 / 150, polish
    with 3 refinement steps) on the recorded stream, 20 ticks at batch 1
    (one under the sync debug mode) and 10 at batch 64, no hand-written
    kernel launched; (b) debug-log mode under both solvers, 5 ticks at
    batch 1 and at batch 64; (c) the four condense modes at batch 256 on
    the first recorded tick, against the sequential chain, timed at batch
    1 and 256. The card is held against the port's CPU run on the first
    FS_CHECK ticks (lanes are independent under both solvers' per-lane
    decisions, so batch 64 is checked on its first FS_CPU_LANES lanes)."""
    from ironcub_mpc_tpu_torch.core.types import expand_lanes
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc

    t_phase = time.perf_counter()
    out = {}
    jitter = (0.1 * np.random.default_rng(0).standard_normal((FS_BATCH, 6))
              ).astype(np.float32)
    settings = admm.ADMMSettings()
    check(settings.kernel_mode == "auto" and settings.max_iter == 250
          and settings.rho_update_iters == (25, 75, 150)
          and settings.polish and settings.polish_refine_iters == 3,
          "full_space: not the default solver settings")
    # the tolerances of tests/test_torch_full.py against JAX
    tol = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
               final_state=2e-5)

    def ticks(rp, batch, n, jit, sync_check_tick=None):
        """n ticks from a fresh configure: host outputs and the mean host ms
        of the ticks after the first, each synchronised."""
        problem, carry = rp.configure(settings)
        _, host, times = run_ticks(mpc, rp, problem, carry, settings, batch,
                                   n, jit, per_tick_sync=rp.est_td.is_cuda,
                                   sync_check_tick=sync_check_tick)
        return host, float(np.mean(times[1:]))

    def against_cpu(gpu, rp_cpu, batch, n, jit, what):
        lanes = min(batch, FS_CPU_LANES)
        cpu, _ = ticks(rp_cpu, lanes, n, None if jit is None else jit[:lanes])
        return lanes, compare_streams(lanes_of(gpu[:n], lanes), cpu, tol,
                                      what)

    # --- (a) the full-space tick ------------------------------------------
    replay = full_replay(dev, qp_solver="full")
    replay_cpu = full_replay("cpu", qp_solver="full")
    check(replay.cfg.n_var == 588 and replay.cfg.n_constraints == 512,
          f"full_space: {replay.cfg.n_var} × {replay.cfg.n_constraints}")
    ticks(replay, 1, 2, None)                                   # warm-up
    for name, batch, n_ticks, jit in (("batch1", 1, FS_TICKS_B1, None),
                                      (f"batch{FS_BATCH}", FS_BATCH,
                                       FS_TICKS_BATCH, jitter)):
        K.reset_launches()
        gpu, ms = ticks(replay, batch, n_ticks, jit,
                        sync_check_tick=2 if batch == 1 else None)
        launches = read_launches(K)
        launches["admm_segment_grouped"] = K.admm_segment_grouped.launches
        check(not any(launches.values()),
              f"full_space {name}: a hand-written kernel launched: {launches}")
        counts = check_solved(gpu, f"full_space {name}")
        lanes, worst = against_cpu(gpu, replay_cpu, batch, FS_CHECK, jit,
                                   f"full_space {name}")
        problem, carry = replay.configure(settings)
        state = [expand_lanes(carry, batch)]
        jit_t = None if jit is None else torch.as_tensor(jit, device=dev)

        def run(n):
            for t in range(n):
                state[0], _ = mpc.mpc_tick(
                    replay.cfg, replay.sched, replay.sel, settings, problem,
                    state[0], *replay.tick_inputs(t, batch, jit_t))

        prof = profile_window(run, FS_PROFILED)
        res = dict(batch=batch, ticks=n_ticks, ms_per_tick=ms,
                   lane_ticks_per_s=1e3 * batch / ms, status_counts=counts,
                   launches=launches, max_err_vs_cpu=worst,
                   cpu_lanes_checked=lanes, profile=prof)
        out[name] = res
        print(f"[full_space] {name}: {ms:.3f} ms/tick over {n_ticks - 1} "
              f"ticks (first excluded), {res['lane_ticks_per_s']:.1f} "
              f"lane-ticks/s, statuses {counts}, hand-written kernel "
              f"launches {launches}, max err vs CPU ({lanes} lanes, "
              f"{FS_CHECK} ticks) {worst}")
        print(f"[full_space] {name}: profiled {prof['ticks']} tick(s): device "
              f"busy {prof['device_busy_ms']} ms of {prof['wall_ms']:.3f} ms "
              f"wall, {prof['device_kernels_per_tick']:.1f} device kernels "
              f"and {prof['linalg_calls_per_tick']:.1f} torch.linalg calls "
              f"a tick, host waits {prof['host_waits']}; heaviest device "
              f"kernels {prof['top_device'][:4]}")
    print("[full_space] batch1: tick 2 passed set_sync_debug_mode('error')")
    out["part_s"] = {"full_tick": time.perf_counter() - t_phase}

    # --- (b) debug-log mode under both solvers ------------------------------
    costs = {}
    for solver in ("condensed", "full"):
        over = dict(qp_solver=solver, enable_debug_log_mode=True)
        rp, rp_cpu = full_replay(dev, **over), full_replay("cpu", **over)
        for batch, jit in ((1, None), (FS_BATCH, jitter)):
            name = f"debug_{solver}_batch{batch}"
            K.reset_launches()
            gpu, ms = ticks(rp, batch, FS_DEBUG_TICKS, jit)
            launches = read_launches(K)
            if solver == "condensed":
                for k, n in launches.items():
                    check(n > 0, f"{name}: {k} was never launched")
            check_solved(gpu, name)
            check_debug(gpu, name)
            lanes, worst = against_cpu(gpu, rp_cpu, batch, FS_DEBUG_TICKS,
                                       jit, name)
            costs[(solver, batch)] = np.stack(
                [o["debug"]["block_costs"] for o in gpu])
            out[name] = dict(batch=batch, ticks=FS_DEBUG_TICKS,
                             ms_per_tick=ms, launches=launches,
                             max_err_vs_cpu=worst)
            print(f"[full_space] {name}: {ms:.3f} ms/tick, launches "
                  f"{launches}, max err vs CPU ({lanes} lanes) {worst}")
    for batch in (1, FS_BATCH):
        a, b = costs[("condensed", batch)], costs[("full", batch)]
        scale = np.maximum(np.abs(b).max(-1), 1.0)
        gap = float((np.abs(a - b).max(-1) / scale).max())
        check(gap < 1e-2, f"debug batch{batch}: block costs of the two "
              f"solvers differ by {gap:.3e} of scale")
        out[f"debug_block_cost_gap_batch{batch}"] = gap
        print(f"[full_space] debug batch{batch}: the two solvers' block "
              f"costs agree within {gap:.3e} of scale (bound 1e-2)")
    out["part_s"]["debug_log"] = (time.perf_counter() - t_phase
                                  - sum(out["part_s"].values()))

    # --- (c) the condense modes ---------------------------------------------
    rp = full_replay(dev)
    problem, carry = rp.configure(settings)
    modes = ("sequential", "assoc", "structured", "paired")
    out["condense_modes"] = {}
    for batch in (1, FS_MODES_BATCH):
        jit = None if batch == 1 else torch.as_tensor(
            (0.1 * np.random.default_rng(0).standard_normal((batch, 6))
             ).astype(np.float32), device=dev)
        c1, prep = mpc._tick_prep(rp.cfg, rp.sel, problem,
                                  expand_lanes(carry, batch),
                                  *rp.tick_inputs(0, batch, jit))
        qps, times = {}, {}
        for m in modes:
            cfg = dataclasses.replace(rp.cfg, condense_mode=m)

            def build(cfg=cfg):
                return mpc.condense_from_prep(cfg, rp.sched, rp.sel,
                                              problem, c1, prep)[0]

            qps[m] = build()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FS_MODE_REPS):
                build()
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0) / FS_MODE_REPS
            times[m] = dict(cuda_event_ms=cuda_ms(build, reps=FS_MODE_REPS),
                            host_ms=host_ms)
        errs = {}
        ref = qps["sequential"]
        f_scale = max(float(ref.f.abs().max()), 1.0)
        for m in modes[1:]:
            q = qps[m]
            e = {"F": float((q.F - ref.F).abs().max()),
                 "f_rel": float((q.f - ref.f).abs().max()) / f_scale,
                 "H_rel": float((q.H - ref.H).abs().max()
                                / ref.H.abs().max()),
                 "q_rel": float((q.q - ref.q).abs().max()
                                / ref.q.abs().max())}
            errs[m] = e
            check(e["F"] <= 5e-5 and e["f_rel"] <= 5e-5 and e["H_rel"] <= 2e-5
                  and e["q_rel"] <= 2e-5 and torch.equal(q.lb, ref.lb)
                  and torch.equal(q.ub, ref.ub),
                  f"condense mode {m} at batch {batch} differs from the "
                  f"sequential chain: {e}")
        out["condense_modes"][f"batch{batch}"] = dict(times=times,
                                                      err_vs_sequential=errs)
        print(f"[full_space] condense modes, batch {batch}: "
              + "; ".join(f"{m} {v['cuda_event_ms']:.3f} ms (CUDA events), "
                          f"{v['host_ms']:.3f} ms (host clock)"
                          for m, v in times.items())
              + f"; against sequential {errs}")
    check(condensed.n_inputs(rp.cfg) == 120, "condense modes: nU != 120")

    out["phase_s"] = time.perf_counter() - t_phase
    out["part_s"]["condense_modes"] = (out["phase_s"]
                                       - sum(out["part_s"].values()))
    print(f"[full_space] the phase took {out['phase_s']:.1f} s "
          f"(budget {FS_BUDGET_S:.0f} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["part_s"].items()))
    check(out["phase_s"] < FS_BUDGET_S,
          f"full_space: {out['phase_s']:.1f} s > {FS_BUDGET_S} s")
    record["full_space"] = out
    return out


# ---------------------------------------------------------------------------
# phase 5c: the parallel axes — the pipelined tick, the row-sharded solve and
# the multi-process dry run
# ---------------------------------------------------------------------------

# the pipelined tick: batch 256 (4 micro-batches of 64), 20 chained ticks
# each way, timed parent/pipeline/pipeline/parent; the first 5 against the
# port's CPU pipeline on 8 lanes; 2 debug-log ticks at batch 64; 3 ticks
# profiled each way
PAR_BATCH, PAR_TICKS, PAR_CPU_LANES, PAR_CPU_TICKS = 256, 20, 8, 5
PAR_DEBUG_BATCH, PAR_DEBUG_TICKS, PAR_PROFILED = 64, 2, 3
# JAX's own bound between its pipelined and vmapped ticks
# (tests/test_pp_pipeline.py), printed beside the port's
JAX_PIPELINE_TOL = 1e-5
# the row-sharded solve: two ranks on the one card against one. x is held
# within TP_TOL of its largest entry: 1e-5 on the 24 x 16 QP; 5e-2 on the
# full-space QP, where the fixed-rho iteration of solve_tp sits at its
# float32 noise floor (its dual residual stalls at 200-400 from iteration 50
# on, SOLVED_INACCURATE) and parts with the summation order: on the CPU
# JAX's own kkt 2 against its kkt 1 by 3.5e-4, kkt 8 by 6.2e-4, the port's
# kkt 2 against its kkt 1 by 1.8e-3 to 3.7e-3 and the port against JAX by
# 4.0e-3; the card's kkt 2 against the CPU's kkt 1 by 1.37e-2 (PERF.md)
TP_RANKS = 2
TP_TOL = {"full_588x512": 5e-2, "dryrun_24x16": 1e-5}
# the dry run at JAX's pod-scale lane count
PAR_POD_LANES = 16384
PAR_BUDGET_S = 150.0


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def hold_lanes(got, want, tol, what):
    """Two chained runs' host outputs, lane by lane: statuses equal but
    SOLVED / SOLVED_INACCURATE flips whose residuals agree within
    FLIP_FACTOR; on the lanes whose statuses agree, the commands and the
    final state within ``tol`` (final_state relative to its largest entry)
    and a DebugInfo within 1e-4 of each field's largest entry. Returns the
    worst errors, the largest error of every field normalised by its
    largest entry (at least 1), and the flips as [tick, lane, primal a,
    primal b, dual a, dual b]."""
    worst = {k: 0.0 for k in tol}
    normalised, flips = 0.0, []
    for t, (g, c) in enumerate(zip(got, want)):
        same = g["status"] == c["status"]
        for lane in np.flatnonzero(~same).tolist():
            pair = {int(g["status"][lane]), int(c["status"][lane])}
            res = [float(v[lane]) for v in (g["pri_res"], c["pri_res"],
                                            g["dua_res"], c["dua_res"])]
            near = all(max(x, y) <= FLIP_FACTOR * min(x, y)
                       for x, y in (res[:2], res[2:]))
            check(pair == {1, 2} and near,
                  f"{what} tick {t} lane {lane}: statuses {pair}, residuals "
                  f"(primal, primal, dual, dual) {res}")
            flips.append([t, lane] + res)
        for k, lim in tol.items():
            a = g[k][same].astype(np.float64)
            b = c[k][same].astype(np.float64)
            err = float(np.abs(a - b).max(initial=0.0))
            scale = max(float(np.abs(b).max(initial=0.0)), 1.0)
            normalised = max(normalised, err / scale)
            if k == "final_state":
                err /= scale
            worst[k] = max(worst[k], err)
            check(err <= lim, f"{what} tick {t}: {k} err {err:.3e} > {lim}")
        for k, v in g.get("debug", {}).items():
            ref = c["debug"][k][same]
            err = float(np.abs(v[same] - ref).max(initial=0.0)) / max(
                float(np.abs(ref).max(initial=0.0)), 1.0)
            worst[f"debug.{k}"] = max(worst.get(f"debug.{k}", 0.0), err)
            check(err <= 1e-4, f"{what} tick {t}: debug {k} err {err:.3e}")
    return worst, normalised, flips


def _tp_rank(rank, port, device, qp_path, out):
    """One rank of the row-sharded solve on a (1, TP_RANKS) mesh over gloo,
    on ``device``: every QP of ``qp_path`` solved once to warm up and once
    timed."""
    import os

    import torch.distributed as dist

    from ironcub_mpc_tpu_torch.parallel import make_mesh, multihost_init
    from ironcub_mpc_tpu_torch.parallel.tp_admm import solve_tp

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(TP_RANKS))
    multihost_init("gloo")
    try:
        mesh = make_mesh(n_scenario=1, n_kkt=TP_RANKS, device=device)
        res = {}
        for name, (qp, settings) in torch.load(
                qp_path, weights_only=False).items():
            qp = [t.to(mesh.device) for t in qp]
            solve_tp(*qp, mesh, settings)
            sync(mesh.device)
            dist.barrier()
            t0 = time.perf_counter()
            sol = solve_tp(*qp, mesh, settings)
            sync(mesh.device)
            res[name] = dict(ms=1e3 * (time.perf_counter() - t0),
                             **{k: v.cpu() for k, v in sol._asdict().items()})
        torch.save(res, f"{out}.rank{rank}")
    finally:
        dist.destroy_process_group()


def tp_problems(dev):
    """The row-sharded solve's QPs: the first recorded tick's full-space QP
    (588 variables, 512 rows, built by qp/assembly.py) and the dry run's
    24 × 16 one, each with its settings, as one lane."""
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import mpc

    fr = full_replay(dev, qp_solver="full")
    problem, carry = fr.configure(admm.ADMMSettings())
    snap, est = fr.tick_inputs(0, 1)
    g, A, lb, ub, _, _ = mpc._assemble(fr.cfg, fr.sched, fr.sel, problem,
                                       carry, snap, est)
    rng = np.random.default_rng(0)
    n, m = 24, 16
    M = rng.normal(size=(n, n))
    small = [torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in
             (M @ M.T + np.eye(n), rng.normal(size=(1, n)),
              rng.normal(size=(m, n)), -np.ones((1, m)), np.ones((1, m)))]
    return {"full_588x512": ([problem.H, g, A, lb, ub],
                             admm.ADMMSettings(polish=False)),
            "dryrun_24x16": (small, admm.ADMMSettings(max_iter=50,
                                                      polish=False))}


def pipelined_against_monolithic(K, replay, problem, carry, settings,
                                 jitter, devices, what):
    """PAR_TICKS chained pipelined ticks (stage i on ``devices[i]``) against
    as many monolithic ticks on the inputs' device, after a warm-up, timed
    in the order monolithic, pipelined, pipelined, monolithic (host clock,
    every device synchronised): both kernels launched and no host read-back
    in the pipelined ticks, every lane solved, the lanes held to each other
    at phase 4's batch-1 tolerances with flips inside the 10x rule, and the
    carries after the last tick. Returns the record and the pipelined
    ticks' host outputs."""
    from ironcub_mpc_tpu_torch.parallel import pipeline_tick
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc

    tight = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
                 final_state=2e-5)

    def piped(*args):
        return pipeline_tick(*args, devices=devices)

    def chain(tick, n):
        t0 = time.perf_counter()
        c, host, _ = run_ticks(mpc, replay, problem, carry, settings,
                               PAR_BATCH, n, jitter, tick=tick)
        for d in set(devices):
            sync(d)
        return c, host, 1e3 * (time.perf_counter() - t0) / n

    chain(mpc.mpc_tick, 2)                 # warm-up: streams, allocator
    chain(piped, 2)
    _, mono, mono_ms = chain(mpc.mpc_tick, PAR_TICKS)
    K.reset_launches()
    condensed.batch_any.syncs = 0
    pipe_carry, pipe, pipe_ms = chain(piped, PAR_TICKS)
    launches = read_launches(K)
    syncs = condensed.batch_any.syncs
    for k, n in launches.items():
        check(n > 0, f"{what}: {k} was never launched in the pipelined "
              "ticks")
    check(syncs == 0, f"{what}: {syncs} host read-backs in the pipelined "
          "ticks")
    _, _, pipe_ms_b = chain(piped, PAR_TICKS)
    mono_carry, _, mono_ms_b = chain(mpc.mpc_tick, PAR_TICKS)
    solved = {"pipelined": check_solved(pipe, f"{what} pipelined"),
              "monolithic": check_solved(mono, f"{what} monolithic")}
    worst, normalised, flips = hold_lanes(pipe, mono, tight,
                                          f"{what} pipelined vs monolithic")
    # the carries after the last tick, on the lanes that never flipped
    never = np.ones(PAR_BATCH, bool)
    for t, lane, *_ in flips:
        never[lane] = False
    carry_err = {}
    for k in ("joints_pos_ref", "throttle_cmd", "thrust_des", "warm_x",
              "kinv", "rho_scalar"):
        a = getattr(pipe_carry, k).double().cpu().numpy()[never]
        b = getattr(mono_carry, k).double().cpu().numpy()[never]
        carry_err[k] = float(np.abs(a - b).max(initial=0.0)) / max(
            float(np.abs(b).max(initial=0.0)), 1.0)
    for k in ("throttle_counter", "pos_traj_idx", "ref_counter",
              "alpha_traj_idx"):
        check(torch.equal(getattr(pipe_carry, k), getattr(mono_carry, k)),
              f"{what}: carry {k} differs from the monolithic ticks")
    for k, lim in (("joints_pos_ref", tight["joints_pos_ref"]),
                   ("throttle_cmd", tight["throttle"]),
                   ("thrust_des", tight["thrust_des"])):
        check(carry_err[k] <= lim,
              f"{what}: carry {k} err {carry_err[k]:.3e} > {lim}")
    rec = dict(
        batch=PAR_BATCH, micro_batch=PAR_BATCH // len(devices),
        ticks=PAR_TICKS, stages_on=[str(d) for d in devices],
        ms_per_tick={"monolithic": [mono_ms, mono_ms_b],
                     "pipelined": [pipe_ms, pipe_ms_b]},
        launches=launches,
        launches_per_tick={k: n / PAR_TICKS for k, n in launches.items()},
        host_readbacks_per_tick=syncs / PAR_TICKS, status_counts=solved,
        max_err_vs_monolithic=worst, carry_err_vs_monolithic=carry_err,
        max_normalised_err=normalised, jax_pipeline_tol=JAX_PIPELINE_TOL,
        flips=flips)
    print(f"[{what}] pipelined tick, batch {PAR_BATCH} in {len(devices)} "
          f"micro-batches, stages on {rec['stages_on']}: {pipe_ms:.3f} / "
          f"{pipe_ms_b:.3f} ms/tick against {mono_ms:.3f} / {mono_ms_b:.3f} "
          f"monolithic (host clock, synchronised, {PAR_TICKS} ticks each, "
          f"order monolithic, pipelined, pipelined, monolithic); host "
          f"read-backs/tick {syncs / PAR_TICKS:.2f}, launches/tick "
          f"{rec['launches_per_tick']}")
    print(f"[{what}] pipelined vs monolithic: statuses {solved}, "
          f"{len(flips)} SOLVED/SOLVED_INACCURATE flips {flips}, max err "
          f"{worst}, carries {carry_err}; largest normalised error "
          f"{normalised:.3e} (JAX's pipelined vs vmapped bound "
          f"{JAX_PIPELINE_TOL:g})")
    return rec, pipe


def phase_parallel(K, dev, record):
    """The pipelined tick against the monolithic one, the row-sharded solve
    over two ranks of the one card against one, and dryrun_multichip(2)."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.parallel import N_STAGES, pipeline_tick
    from ironcub_mpc_tpu_torch.parallel.dryrun import dryrun_multichip
    from ironcub_mpc_tpu_torch.parallel.tp_admm import solve_tp
    from ironcub_mpc_tpu_torch.qp import mpc

    t_phase = time.perf_counter()
    out = {}
    # --- a. the pipelined tick -------------------------------------------
    settings = admm.ADMMSettings(**BENCH)
    check(not settings.batch_guard and settings.kernel_mode == "auto",
          "parallel: the pipelined tick takes per-lane decisions and kernels")
    tight = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
                 final_state=2e-5)
    loose = dict(tight, throttle=0.1, final_state=1e-2)
    replay = full_replay(dev)
    replay_cpu = full_replay("cpu")
    problem, carry = replay.configure(settings)
    nu = problem.H_u.shape[-1]
    check(K._pad_to(nu) == P, f"parallel: nU {nu} does not pad to {P}")
    jitter = (0.1 * np.random.default_rng(0).standard_normal((PAR_BATCH, 6))
              ).astype(np.float32)

    out["pipeline"], pipe = pipelined_against_monolithic(
        K, replay, problem, carry, settings, jitter, [dev] * N_STAGES,
        "parallel")

    def chain(tick, n, rp, pr, ca, batch, jit):
        return run_ticks(mpc, rp, pr, ca, settings, batch, n, jit,
                         tick=tick)[1]

    def piped(*args):
        return pipeline_tick(*args, devices=[dev] * N_STAGES)

    # the port's CPU pipeline on the first lanes
    problem_c, carry_c = replay_cpu.configure(settings)
    cpu = chain(pipeline_tick, PAR_CPU_TICKS, replay_cpu, problem_c, carry_c,
                PAR_CPU_LANES, jitter[:PAR_CPU_LANES])
    cpu_worst, _, cpu_flips = hold_lanes(
        lanes_of(pipe[:PAR_CPU_TICKS], PAR_CPU_LANES), cpu, loose,
        "parallel pipelined card vs CPU")
    # debug-log mode
    rd = full_replay(dev, enable_debug_log_mode=True)
    pd, cd = rd.configure(settings)
    dbg = [chain(f, PAR_DEBUG_TICKS, rd, pd, cd, PAR_DEBUG_BATCH,
                 jitter[:PAR_DEBUG_BATCH]) for f in (piped, mpc.mpc_tick)]
    check_debug(dbg[0], "parallel debug-log pipelined")
    dbg_worst, _, dbg_flips = hold_lanes(*dbg, tight, "parallel debug-log")
    prof = {name: profile_window(lambda n, f=f: chain(
        f, n, replay, problem, carry, PAR_BATCH, jitter), n=PAR_PROFILED)
            for name, f in (("pipelined", piped),
                            ("monolithic", mpc.mpc_tick))}
    out["pipeline"].update(max_err_vs_cpu=cpu_worst, cpu_flips=cpu_flips,
                           debug_max_err=dbg_worst, debug_flips=dbg_flips,
                           profile=prof)
    print(f"[parallel] card vs CPU pipeline ({PAR_CPU_LANES} lanes, "
          f"{PAR_CPU_TICKS} ticks) {cpu_worst}, flips {cpu_flips}; "
          f"debug-log {dbg_worst}, flips {dbg_flips}")
    for name, p in prof.items():
        # the profiler slows the host many times over (most for the
        # pipeline's streams and events), so the busy share is taken
        # against the unprofiled ms a tick of the same run
        ms = out["pipeline"]["ms_per_tick"][name]
        busy = p["device_busy_ms"]
        p["busy_share_unprofiled"] = (
            [busy / p["ticks"] / m for m in ms] if isinstance(busy, float)
            else "not measured")
        print(f"[parallel] {name}: profiled {p['ticks']} ticks: device busy "
              f"{busy} ms summed, {p['device_union_ms']} ms as a union of "
              f"intervals, of {p['wall_ms']:.3f} ms wall under the profiler; "
              f"busy share against the unprofiled ms/tick "
              f"{p['busy_share_unprofiled']}; "
              f"{p['device_kernels_per_tick']:.1f} device kernels/tick, "
              f"kernels {p['kernels']}")

    # --- b. the row-sharded solve over two ranks of the one card --------
    qps = tp_problems(dev)
    check(tuple(qps["full_588x512"][0][2].shape) == (1, 512, 588),
          f"parallel: the full-space QP is {qps['full_588x512'][0][2].shape}")
    with tempfile.TemporaryDirectory() as td:
        path, res_path = f"{td}/qps.pt", f"{td}/tp"
        torch.save({k: ([t.cpu() for t in qp], s)
                    for k, (qp, s) in qps.items()}, path)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.spawn(_tp_rank, args=(port, str(dev), path, res_path),
                 nprocs=TP_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{res_path}.rank{r}", weights_only=True)
                 for r in range(TP_RANKS)]
    out["tp"] = dict(ranks=TP_RANKS, backend="gloo", spawn_and_solve_s=spawn_s)
    for name, (qp, s) in qps.items():
        sharded = ranks[0][name]
        for other in ranks[1:]:
            for k in ("x", "y", "z", "status"):
                check(torch.equal(other[name][k], sharded[k]),
                      f"parallel tp {name}: {k} differs between the ranks")
        solve_tp(*qp, None, s)
        sync(dev)
        t0 = time.perf_counter()
        one = solve_tp(*qp, None, s)
        sync(dev)
        one_ms = 1e3 * (time.perf_counter() - t0)
        cpu_sol = solve_tp(*[t.cpu() for t in qp], None, s)
        m = qp[2].shape[-2]
        check(tuple(sharded["y"].shape) == tuple(sharded["z"].shape)
              == (1, m), f"parallel tp {name}: y {sharded['y'].shape}")
        errs = {}
        for ref_name, ref in (("kkt1_card", one), ("kkt1_cpu", cpu_sol)):
            host = {k: [getattr(ref, k).cpu().numpy()]
                    for k in ("status", "pri_res", "dua_res")}
            flips = hold_lanes(
                [{k: sharded[k].numpy() for k in host}],
                [{k: v[0] for k, v in host.items()}], {},
                f"parallel tp {name} against {ref_name}")[2]
            x_ref = ref.x.cpu()
            errs[ref_name] = float((sharded["x"] - x_ref).abs().max()) / max(
                float(x_ref.abs().max()), 1e-30)
            check(errs[ref_name] <= TP_TOL[name],
                  f"parallel tp {name}: x against {ref_name} "
                  f"{errs[ref_name]:.3e} of its largest entry > "
                  f"{TP_TOL[name]}")
            errs[f"{ref_name}_flips"] = flips
            check(bool(torch.isfinite(sharded["x"]).all()),
                  f"parallel tp {name}: non-finite x")
        out["tp"][name] = dict(
            n=int(qp[0].shape[-1]), m=int(m), max_iter=s.max_iter,
            status=int(sharded["status"]), pri_res=float(sharded["pri_res"]),
            dua_res=float(sharded["dua_res"]), x_err=errs,
            ms={f"kkt{TP_RANKS}_gloo": sharded["ms"], "kkt1": one_ms})
        print(f"[parallel] tp {name}: status {int(sharded['status'])}, x "
              f"against kkt 1 on the card / on the CPU {errs['kkt1_card']:.3e}"
              f" / {errs['kkt1_cpu']:.3e} of its largest entry; one solve "
              f"({s.max_iter} iterations) {sharded['ms']:.2f} ms over "
              f"{TP_RANKS} gloo ranks (each all-reduce staged through the "
              f"host) against {one_ms:.2f} ms on one rank")

    # --- c. the dry run -----------------------------------------------------
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=dev, pod_lanes=PAR_POD_LANES)
    dry["wall_s"] = time.perf_counter() - t0
    for k, n in dry["flagship"]["launches"].items():
        check(n > 0, f"parallel dryrun: {k} was never launched in the "
              "flagship sweep")
    check(dry["mesh"] == {"scenario": 1, "kkt": 2} and "tp" in dry
          and "pipeline" in dry, f"parallel dryrun: {dry}")
    out["dryrun"] = dry
    print(f"[parallel] dryrun_multichip(2): {dry}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[parallel] the phase took {out['phase_s']:.1f} s")
    check(out["phase_s"] < PAR_BUDGET_S,
          f"parallel: {out['phase_s']:.1f} s > {PAR_BUDGET_S} s")
    record["parallel"] = out
    return out


def phase_parallel_cards(K, n_cards, record):
    """The parallel axes across ``n_cards`` cards (``--cards N``): the
    pipelined tick with stage i on card i % N (peer copies between the
    stages' streams) against the monolithic tick on card 0, and
    dryrun_multichip(N) with a card a rank (nccl)."""
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.parallel import N_STAGES
    from ironcub_mpc_tpu_torch.parallel.dryrun import dryrun_multichip

    check(torch.cuda.device_count() >= n_cards,
          f"cards: {torch.cuda.device_count()} visible, {n_cards} asked for")
    settings = admm.ADMMSettings(**BENCH)
    replay = full_replay(torch.device("cuda", 0))
    problem, carry = replay.configure(settings)
    jitter = (0.1 * np.random.default_rng(0).standard_normal((PAR_BATCH, 6))
              ).astype(np.float32)
    out, _ = pipelined_against_monolithic(
        K, replay, problem, carry, settings, jitter,
        [torch.device("cuda", i % n_cards) for i in range(N_STAGES)],
        "cards")
    out["cards"] = n_cards
    t0 = time.perf_counter()
    dry = dryrun_multichip(n_cards, pod_lanes=PAR_POD_LANES)
    dry["wall_s"] = time.perf_counter() - t0
    for k, n in dry["flagship"]["launches"].items():
        check(n > 0, f"cards dryrun: {k} was never launched")
    out["dryrun"] = dry
    print(f"[cards] dryrun_multichip({n_cards}): {dry}")
    record["cards"] = out
    return out


# ---------------------------------------------------------------------------
# phase 5d: the host side (native runtime, real-time driver, profiling,
# telemetry, host MuJoCo)
# ---------------------------------------------------------------------------

# the bounds of tests/test_plant_divergence.py on the cross-engine run
PLANT_DIV_BOUNDS = dict(com_div_max_m=0.06, rpy_div_max_deg=8.0,
                        base_div_max_m=0.09, thrust_div_max_n=1.5)


def driver_syncs(tick, n):
    """Calls that make the host wait for the card in ``n`` driver ticks:
    each is one warning under ``set_sync_debug_mode("warn")``. Returns
    their number a tick and, by tick, where they were made."""
    import warnings

    where = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in range(n):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tick()
            calls = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                     if "called a synchronizing" in str(w.message)]
            if calls:
                where[i] = calls
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum(len(c) for c in where.values()) / n, where


def host_mujoco(dev, out):
    """HostMujocoSim on the card: the snapshot's CoM against MuJoCo's, 40
    closed-loop ticks, and compare_plants over 300 ticks within the bounds
    of tests/test_plant_divergence.py."""
    import mujoco

    from ironcub_mpc_tpu_torch.core.config import (MPCConfig, RobotConfig,
                                                   SimConfig, joint_selector)
    from ironcub_mpc_tpu_torch.dynamics import KinDyn, build_ironcub_model
    from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import mpc
    from ironcub_mpc_tpu_torch.runtime.flight import standing_geometry
    from ironcub_mpc_tpu_torch.sim.mujoco_sim import HostMujocoSim
    from ironcub_mpc_tpu_torch.sim.validate import compare_plants

    kd = KinDyn(build_ironcub_model(), device=dev)
    sim = HostMujocoSim(kd, RobotConfig(), SimConfig(use_nn_jet_dynamics=False))
    q0, z_min = standing_geometry(kd, SimConfig().initial_position_deg)
    sim.set_state(np.eye(3), [0.0, 0.0, -z_min + 0.01], q0)
    sim.set_joint_positions(q0)
    sim.set_thrust(np.full(4, 10.0))
    sim.step(500)
    snap = sim.snapshot()
    mujoco.mj_forward(sim.model, sim.data)
    com_err = float(np.abs(snap.com_pos[0].cpu().numpy()
                           - sim.data.subtree_com[1]).max())
    check(com_err <= 1e-4, f"host_runtime mujoco: CoM {com_err:.3e} m from "
          "MuJoCo's")
    cfg = MPCConfig()
    sched, sel = build_schedule(cfg), joint_selector(RobotConfig(), cfg)
    settings = admm.ADMMSettings(max_iter=60)
    channels = {k: np.zeros((30, 3)) for k in
                ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
    problem, carry = mpc.configure(cfg, sched, sel, snap, channels,
                                   np.full(600, 0.08), settings, device=dev)
    statuses = []
    t0 = time.perf_counter()
    for _ in range(HM_TICKS):
        carry, o = mpc.mpc_tick(cfg, sched, sel, settings, problem, carry,
                                sim.snapshot(), sim.estimated_thrust_dot())
        host = torch.cat([o.joints_pos_ref[0], o.throttle[0],
                          o.thrust_des[0], o.status.float()]).cpu().numpy()
        n = kd.n
        sim.set_joint_positions(host[:n])
        sim.set_throttle(host[n:n + 4])
        sim.set_thrust(host[n + 4:n + 8])
        statuses.append(int(host[n + 8]))
        sim.step(5)
    loop_ms = 1e3 * (time.perf_counter() - t0) / HM_TICKS
    check(all(s in (admm.SOLVED, admm.SOLVED_INACCURATE) for s in statuses),
          f"host_runtime mujoco: statuses {statuses}")
    t0 = time.perf_counter()
    rep = compare_plants(n_ticks=HM_COMPARE_TICKS, device=dev)
    rep["wall_s"] = time.perf_counter() - t0
    check(rep["finite"] and rep["torch_solved_frac"] == 1.0
          and rep["mujoco_solved_frac"] == 1.0,
          f"host_runtime compare_plants: {rep}")
    for k, lim in PLANT_DIV_BOUNDS.items():
        check(rep[k] < lim, f"host_runtime compare_plants: {k} {rep[k]} >= "
              f"{lim}")
    out["host_mujoco"] = dict(com_err_m=com_err, ticks=HM_TICKS,
                              ms_per_tick=loop_ms, compare_plants=rep)
    print(f"[host_runtime] mujoco {mujoco.__version__}: snapshot CoM "
          f"{com_err:.2e} m from MuJoCo's, {HM_TICKS} closed-loop ticks "
          f"solved at {loop_ms:.3f} ms/tick; compare_plants({HM_COMPARE_TICKS})"
          f" {rep}")


def phase_host_runtime(K, dev, record, main_runs):
    """The native library built by g++ and its ring's stress; the real-time
    driver paced at twice its tick and at the reference's 5 ms, its host
    waits and kernels a tick; a device trace; solves/s of the batch-256
    replay tick; a telemetry .mat round trip; the host-MuJoCo plant where
    MuJoCo is installed."""
    import importlib.util

    import scipy.io

    from ironcub_mpc_tpu_torch.core.types import expand_lanes, tree_map
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import mpc
    from ironcub_mpc_tpu_torch.runtime import flight, native, telemetry
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay
    from ironcub_mpc_tpu_torch.utils.profiling import (device_trace,
                                                       solves_per_second)

    sys.path.insert(0, str(ROOT / "examples"))
    import realtime_driver_torch as rtd

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = {}
    # --- a. the native library --------------------------------------------
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    check(native.available(), "host_runtime: native library not loaded")
    t0 = time.perf_counter()
    rc = native.ring_stress(1024, 8, 2_000_000)
    stress_s = time.perf_counter() - t0
    check(rc == 0, f"host_runtime: ring_stress error class {rc}")
    policy = os.sched_getscheduler(0)
    out["native"] = dict(lib=path.name, build_s=build_s, ring_stress_rc=rc,
                         ring_stress_s=stress_s,
                         sched_policy={os.SCHED_OTHER: "SCHED_OTHER",
                                       os.SCHED_FIFO: "SCHED_FIFO",
                                       os.SCHED_RR: "SCHED_RR"}.get(
                                           policy, str(policy)))
    print(f"[host_runtime] native: g++ build {build_s:.2f} s ({path.name}), "
          f"ring_stress(1024, 8, 2e6) rc {rc} in {stress_s:.2f} s, "
          f"policy {out['native']['sched_policy']}")

    # --- b. the real-time driver on the card -------------------------------
    tick = rtd.HoverTick(dev)
    for _ in range(3):
        tick()
    probe = []
    for _ in range(RT_PROBE):
        t0 = time.perf_counter()
        tick()
        probe.append(1e3 * (time.perf_counter() - t0))
    probe_ms = float(np.mean(probe))
    period_s = max(RT_MIN_PERIOD_S, 2e-3 * probe_ms)
    drain = out_dir / "rt_paced.f32"
    K.reset_launches()
    paced = rtd.run(RT_TICKS, period_s, drain_path=str(drain), verbose=False,
                    tick=tick)
    launches = read_launches(K)
    rec = np.fromfile(drain, np.float32).reshape(-1, rtd.RECORD_LEN)
    for k, n in launches.items():
        check(n > 0, f"host_runtime driver: {k} was never launched")
    check(paced["drained_records"] == RT_TICKS and len(rec) == RT_TICKS,
          f"host_runtime driver: {paced['drained_records']} records drained")
    check(paced["ring_dropped"] == 0,
          f"host_runtime driver: {paced['ring_dropped']} records dropped")
    check(np.isin(rec[:, 1], (admm.SOLVED, admm.SOLVED_INACCURATE)).all(),
          f"host_runtime driver: statuses {np.unique(rec[:, 1])}")
    check(paced["overruns"] <= RT_OVERRUN_FRAC * RT_TICKS,
          f"host_runtime driver: {paced['overruns']} overruns of {RT_TICKS} "
          f"ticks at {1e3 * period_s:.1f} ms")
    fast = rtd.run(RT_TICKS, RT_REF_PERIOD_S,
                   drain_path=str(out_dir / "rt_5ms.f32"), verbose=False,
                   tick=tick)
    prof = profile_window(lambda n: [tick() for _ in range(n)])
    d2h = sum(n for k, n in prof["copies"].items() if "DtoH" in k)
    syncs, where = driver_syncs(tick, RT_SYNC_TICKS)
    per_tick = dict(syncs=syncs, device_to_host=d2h / prof["ticks"])
    check(per_tick["syncs"] == 1 and per_tick["device_to_host"] == 1,
          f"host_runtime driver: {per_tick} host waits and device-to-host "
          f"copies a tick, 1 and 1 expected (copies {prof['copies']}, "
          f"waits by tick {where})")
    for k in ("admm_segment", "woodbury_ns"):
        check(prof["kernels"].get(k, {}).get("calls", 0) > 0,
              f"host_runtime driver: {k} not in the profiled ticks")
    busy = prof["device_busy_ms"]
    prof["busy_share_unprofiled"] = (
        busy / prof["ticks"] / paced["mean_solve_ms"]
        if not isinstance(busy, str) else busy)
    out["driver"] = dict(probe_ms=probe_ms, period_ms=1e3 * period_s,
                         paced=paced, ref_5ms=fast, launches=launches,
                         launches_per_tick={k: n / (RT_TICKS + 20)
                                            for k, n in launches.items()},
                         waits_per_tick=per_tick, profile=prof)
    print(f"[host_runtime] driver: {RT_PROBE}-tick probe {probe_ms:.3f} ms; "
          f"{RT_TICKS} ticks paced at {1e3 * period_s:.1f} ms: mean "
          f"{paced['mean_solve_ms']:.3f} ms, p99 {paced['p99_solve_ms']:.3f} "
          f"ms, {paced['overruns']} overruns, {paced['drained_records']} "
          f"drained, {paced['ring_dropped']} dropped; launches {launches}")
    print(f"[host_runtime] driver at 5 ms: mean {fast['mean_solve_ms']:.3f} "
          f"ms, p99 {fast['p99_solve_ms']:.3f} ms, {fast['overruns']} "
          f"overruns of {RT_TICKS} ({fast['overruns_warmup']} warm-up / "
          f"{fast['overruns_steady']} steady), {fast['stall_events']} stall "
          f"events, worst lateness {fast['worst_lateness_ms']:.1f} ms")
    print(f"[host_runtime] driver profiled {prof['ticks']} ticks: "
          f"{per_tick['syncs']:.0f} host wait and "
          f"{per_tick['device_to_host']:.0f} device-to-host copy a tick "
          f"(copies {prof['copies']}), device busy {busy} ms of "
          f"{prof['wall_ms']:.3f} ms (a tick's device time over the paced "
          f"mean tick: {prof['busy_share_unprofiled']}), "
          f"{prof['device_kernels_per_tick']:.1f} device kernels/tick, "
          f"kernels {prof['kernels']}")

    # --- c. profiling helpers ----------------------------------------------
    trace_dir = out_dir / "host_runtime_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with device_trace(str(trace_dir)):
        tick()
        tick()
    traces = list(trace_dir.glob("trace_*.json"))
    check(len(traces) == 1, f"host_runtime: {len(traces)} trace files")
    text = traces[0].read_text()
    for k in ("admm_segment", "woodbury_ns"):
        check(k in text, f"host_runtime: the trace does not name {k}")
    replay = load_flight_replay(device=dev)
    settings = admm.ADMMSettings(**BENCH, batch_guard=True)
    problem, carry = replay.configure(settings)
    jitter = torch.as_tensor(
        (0.1 * np.random.default_rng(0).standard_normal((BATCH, 6))
         ).astype(np.float32), device=dev)
    snap, est = replay.tick_inputs(0, BATCH, jitter)
    sps = solves_per_second(BATCH, SPS_ITERS, mpc.mpc_tick, replay.cfg,
                            replay.sched, replay.sel, settings, problem,
                            expand_lanes(carry, BATCH), snap, est)
    main_sps = main_runs[f"batch{BATCH}"]["solves_per_s"]
    out["profiling"] = dict(trace_bytes=len(text), trace=traces[0].name,
                            solves_per_s=sps, main_solves_per_s=main_sps)
    print(f"[host_runtime] device_trace of 2 driver ticks: {len(text)} bytes "
          f"naming both kernels; solves_per_second at batch {BATCH}: "
          f"{sps:.1f} (phase 4's chained ticks {main_sps:.1f}, "
          f"{main_runs[f'batch{BATCH}']['ms_per_tick']:.3f} ms/tick)")

    # --- d. telemetry to .mat ----------------------------------------------
    loop, pos_traj, alpha_traj = flight.build_flight_loop(device=dev)
    period = loop.cfg.period_mpc
    tel, _ = flight.run_flight(TEL_TICKS * period, settle_s=0.05, loop=loop,
                               pos_traj=pos_traj, alpha_traj=alpha_traj)
    lane0 = tree_map(lambda v: v[:, 0], tel)
    want = telemetry.to_mat_dict(lane0, period)
    path = telemetry.save_mat(lane0, str(out_dir / "host_runtime.mat"),
                              period)
    back = scipy.io.loadmat(path)
    keys = list(telemetry.MAT_KEYS.values()) + ["time_controller"]
    check(sorted(want) == sorted(keys), f"host_runtime mat: keys {sorted(want)}")
    for k in keys:
        v = np.atleast_2d(want[k])
        check(k in back and back[k].shape == v.shape
              and np.array_equal(back[k], v),
              f"host_runtime mat: {k} does not round-trip")
    check(want["CoMPosition"].shape == (TEL_TICKS, 3)
          and want["joints_pos_ref"].shape == (TEL_TICKS, 23),
          "host_runtime mat: channel shapes")
    out["telemetry"] = dict(ticks=TEL_TICKS, keys=len(keys),
                            bytes=Path(path).stat().st_size)
    print(f"[host_runtime] telemetry: {TEL_TICKS} closed-loop ticks saved to "
          f"{Path(path).name} ({out['telemetry']['bytes']} bytes), {len(keys)} "
          f"channels round-trip through scipy.io.loadmat")

    # --- e. host MuJoCo -----------------------------------------------------
    if importlib.util.find_spec("mujoco") is None:
        out["host_mujoco"] = "not installed"
        print("[host_runtime] mujoco is not installed on this machine: the "
              "host-MuJoCo part did not run")
    else:
        host_mujoco(dev, out)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[host_runtime] phase {out['phase_s']:.1f} s")
    check(out["phase_s"] <= HOST_BUDGET_S,
          f"host_runtime took {out['phase_s']:.1f} s > {HOST_BUDGET_S} s")
    record["host_runtime"] = out
    return out


# ---------------------------------------------------------------------------
# phase 6: the closed-loop flight (path B)
# ---------------------------------------------------------------------------


def lane_stats(flight, tel, lane, period, mass):
    """flight_stats of one lane of a batched telemetry record."""
    one = type(tel)(*(None if v is None else v[:, lane].cpu().numpy()
                      for v in tel))
    return flight.flight_stats(one, period, total_mass=mass)


def flight_split(loop, problem, carry, n=20):
    """Host-clock ms of the three layers of a tick over ``n`` separate
    ticks, each section ending in a synchronise: the snapshot, the MPC tick
    and the 5 plant substeps. The sections are timed on the current carry and
    the carry is then advanced by the loop's own tick."""
    from ironcub_mpc_tpu_torch.qp import mpc

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    rows = []
    for _ in range(n):
        (snap, s), t_snap = timed(lambda: loop.snapshot(carry.plant))
        _, t_mpc = timed(lambda: mpc.mpc_tick(
            loop.cfg, loop.sched, loop.sel, loop.settings, problem,
            carry.mpc, snap, s.ekf.x[..., 1]))
        _, t_plant = timed(lambda: loop.plant.step(s, loop.n_substeps))
        (carry, _), t_tick = timed(lambda: loop.tick(problem, carry))
        rows.append((t_snap, t_mpc, t_plant, t_tick))
    a = np.asarray(rows)
    # inside one 1 kHz substep: the whole substep, and its jet model alone
    # (LSTM cell + EKF update); device kernels and device time per substep
    plant, s = loop.plant, carry.plant
    sub = np.asarray([(
        timed(lambda: plant.substep(s))[1],
        timed(lambda: plant.ekf.update(
            s.ekf, s.throttle,
            *plant.lstm.step(s.thrust_nn, s.throttle, plant.dt)))[1])
        for _ in range(n)])
    prof = profile_window(lambda k: [plant.substep(s) for _ in range(k)])
    busy = prof["device_busy_ms"]
    return carry, dict(ticks=n, snapshot_ms=float(a[:, 0].mean()),
                       mpc_tick_ms=float(a[:, 1].mean()),
                       plant_5_substeps_ms=float(a[:, 2].mean()),
                       whole_tick_ms=float(a[:, 3].mean()),
                       whole_tick_ms_p50=float(np.median(a[:, 3])),
                       substep_ms=float(sub[:, 0].mean()),
                       substep_lstm_ekf_ms=float(sub[:, 1].mean()),
                       substep_device_kernels=prof["device_kernels_per_tick"],
                       substep_device_ms=(busy if isinstance(busy, str)
                                          else busy / prof["ticks"]))


def phase_flight(K, dev, record):
    from ironcub_mpc_tpu_torch import convert
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.runtime import flight
    from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop

    out = {}
    loop, pos_traj, alpha_traj = flight.build_flight_loop(device=dev)
    check(loop.kd.n == 23 and loop.plant.lstm is not None,
          "flight: not the 23-joint model with the LSTM jets")
    period = loop.cfg.period_mpc
    mass = loop.kd.model.total_mass
    channels, alpha = flight.mission_inputs(pos_traj, alpha_traj)
    q0_deg = loop.plant.sim_cfg.initial_position_deg

    # --- batch 1: the real-time loop through the flight entry point -------
    flight.run_flight(0.05, settle_s=0.05, loop=loop, pos_traj=pos_traj,
                      alpha_traj=alpha_traj)                     # warm-up
    K.reset_launches()
    condensed.batch_any.syncs = 0
    tel, info = flight.run_flight(FLIGHT_B1_S, settle_s=FLIGHT_SETTLE_S,
                                  loop=loop, pos_traj=pos_traj,
                                  alpha_traj=alpha_traj)
    launches = read_launches(K)
    syncs = condensed.batch_any.syncs
    n1 = info["n_ticks"]
    check(n1 >= 400, f"flight batch1: only {n1} ticks")
    for k, n in launches.items():
        check(n > 0, f"flight batch1: {k} was never launched")
    stats = lane_stats(flight, tel, 0, period, mass)
    check(stats["finite"] and stats["n_not_solved"] == 0,
          f"flight batch1: {stats}")
    check(tuple(tel.com_position.shape) == (n1, 1, 3)
          and tuple(tel.joints_pos_ref.shape) == (n1, 1, 23),
          "flight batch1: telemetry shapes")

    # the first 20 ticks against the port's own CPU run (the plain twins)
    # from the same settled state
    s = loop.settle(flight.standing_state(loop.plant, q0_deg),
                    FLIGHT_SETTLE_S)
    settled = s
    problem, carry = loop.configure(s, channels, alpha)
    loop_c, _, _ = flight.build_flight_loop(device="cpu")
    problem_c, carry_c = loop_c.configure(convert.to_device(s, "cpu"),
                                          channels, alpha)
    _, tel_c = loop_c.rollout(problem_c, carry_c, N_CHECK)
    g = {k: getattr(tel, k)[:N_CHECK].cpu().numpy() for k in
         ("com_position", "throttle", "solver_status")}
    c = {k: getattr(tel_c, k).numpy() for k in g}
    check(np.array_equal(g["solver_status"], c["solver_status"]),
          "flight batch1: status differs from the CPU run")
    worst = {k: float(np.abs(g[k] - c[k]).max())
             for k in ("com_position", "throttle")}
    check(worst["com_position"] <= 1e-4 and worst["throttle"] <= 0.1,
          f"flight batch1: first {N_CHECK} ticks differ from the CPU run: "
          f"{worst}")

    # with per-lane decisions a tick must not wait for the device anywhere
    # (no read-back, no host-to-device copy): any synchronising call raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, _ = loop.tick(problem, carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    carry, split = flight_split(loop, problem, carry)
    state = [carry]

    def fly(n):
        for _ in range(n):
            state[0], _ = loop.tick(problem, state[0])

    prof = profile_window(fly)
    out["batch1"] = dict(
        info=info, stats=stats, launches=launches,
        launches_per_tick={k: n / n1 for k, n in launches.items()},
        batch_any_syncs_per_tick=syncs / n1, max_err_vs_cpu=worst,
        split=split, profile=prof)
    print(f"[flight] batch1: {info['ms_per_tick']:.3f} ms/tick over {n1} "
          f"ticks (5 ms period), settle {info['settle_wall_s']} s, launches "
          f"{launches}, batch-wide host decisions/tick {syncs / n1:.2f}, "
          f"max err vs CPU {worst}")
    print(f"[flight] batch1: split over {split['ticks']} ticks: snapshot "
          f"{split['snapshot_ms']:.3f} ms, MPC tick "
          f"{split['mpc_tick_ms']:.3f} ms, 5 plant substeps "
          f"{split['plant_5_substeps_ms']:.3f} ms, whole tick "
          f"{split['whole_tick_ms']:.3f} ms; one substep "
          f"{split['substep_ms']:.3f} ms (LSTM + EKF "
          f"{split['substep_lstm_ekf_ms']:.3f} ms), "
          f"{split['substep_device_kernels']:.1f} device kernels and "
          f"{split['substep_device_ms']} ms of device time per substep")
    print(f"[flight] batch1: profiled {prof['ticks']} ticks: device busy "
          f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.3f} ms wall, "
          f"{prof['device_kernels_per_tick']:.1f} device kernels/tick, host "
          f"waits {prof['host_waits']}, kernels {prof['kernels']}")
    print(f"[flight] batch1: {stats}")

    # --- batch 64: batch-wide decisions, a seeded wind per lane ------------
    B = FLIGHT_BATCH
    loop_b = ClosedLoop(loop.plant, loop.cfg,
                        dataclasses.replace(loop.settings, batch_guard=True))
    wind = (WIND_STD_N * np.random.default_rng(0).standard_normal((B, 3))
            ).astype(np.float32)
    wind[0] = 0.0                          # lane 0 flies the nominal mission
    t0 = time.perf_counter()
    s = loop_b.settle(flight.standing_state(loop.plant, q0_deg, batch=B),
                      FLIGHT_SETTLE_S)
    s = s._replace(wind_force=torch.as_tensor(wind, device=dev))
    problem, carry = loop_b.configure(s, channels, alpha)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    # a short probe sets how many ticks fit the script's time budget
    t0 = time.perf_counter()
    loop_b.rollout(problem, carry, 20)
    torch.cuda.synchronize()
    probe_ms = 1e3 * (time.perf_counter() - t0) / 20
    left_s = (SCRIPT_BUDGET_S - (time.perf_counter() - T_START) - 20.0
              - FID_BUDGET_S - sweep_reserve_s(probe_ms))
    full = int(round(FLIGHT_SLICE_S / period))
    n_ticks = max(200, min(full, int(1e3 * left_s / (1.1 * probe_ms))))
    bench_s = record["bench"]["phase_s"]
    print(f"[flight] the bench phase's {bench_s:.1f} s are "
          f"~{int(1e3 * bench_s / (1.1 * probe_ms))} ticks of this slice at "
          f"the probe's {probe_ms:.3f} ms a tick")
    K.reset_launches()
    condensed.batch_any.syncs = 0
    t0 = time.perf_counter()
    carry, tel = loop_b.rollout(problem, carry, n_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(K)
    syncs = condensed.batch_any.syncs
    for k, n in launches.items():
        check(n > 0, f"flight batch{B}: {k} was never launched")
    per_lane = [lane_stats(flight, tel, i, period, mass) for i in range(B)]
    for i, st in enumerate(per_lane):
        check(st["finite"] and st["n_not_solved"] == 0,
              f"flight batch{B}: lane {i}: {st}")
    st0 = per_lane[0]
    flew_slice = n_ticks == full
    # the bounds of the 20 s flight-regression slice, on the wind-free lane:
    # the maxima hold on any prefix of the slice, the RMSEs and the takeoff
    # time only on the whole of it
    check(st0["com_max_m"] < 0.15 and st0["rpy_max_deg"] < 6.0,
          f"flight batch{B}: lane 0 outside the regression maxima: {st0}")
    if flew_slice:
        check(st0["com_rmse_m"] < 0.06 and st0["rpy_rmse_deg"] < 2.0
              and 10.0 < st0.get("takeoff_t_s", -1.0) < 20.0,
              f"flight batch{B}: lane 0 outside the regression bounds: {st0}")
    else:
        print(f"[flight] WARNING: batch{B} slice cut to {n_ticks} of {full} "
              f"ticks by the time budget; RMSE and takeoff bounds of the "
              f"flight regression not checked")
    ms_tick = 1e3 * wall / n_ticks
    spread = {k: [float(np.min([st[k] for st in per_lane])),
                  float(np.max([st[k] for st in per_lane]))]
              for k in ("com_rmse_m", "com_max_m", "rpy_rmse_deg",
                        "rpy_max_deg")}
    out[f"batch{B}"] = dict(
        batch=B, ticks=n_ticks, flown_s=n_ticks * period,
        flew_whole_slice=flew_slice, settle_and_configure_s=settle_s,
        probe_ms_per_tick=probe_ms, rollout_wall_s=wall, ms_per_tick=ms_tick,
        lane_ticks_per_s=1e3 * B / ms_tick,
        realtime_factor=n_ticks * period / wall, launches=launches,
        launches_per_tick={k: n / n_ticks for k, n in launches.items()},
        batch_any_syncs_per_tick=syncs / n_ticks, lane0=st0,
        lanes_spread=spread, wind_std_n=WIND_STD_N)
    print(f"[flight] batch{B}: flew {n_ticks * period:.1f} s of the mission "
          f"({n_ticks} ticks) in {wall:.1f} s: {ms_tick:.3f} ms/tick, "
          f"{1e3 * B / ms_tick:.1f} lane-ticks/s, host syncs/tick "
          f"{syncs / n_ticks:.2f}, launches {launches}")
    print(f"[flight] batch{B}: lane 0 {st0}")
    print(f"[flight] batch{B}: lanes min/max {spread}")
    record["flight"] = out
    return out, (loop, settled, channels, alpha)


# ---------------------------------------------------------------------------
# phase 6b: the float64-oracle mirror on the card, and the tools
# ---------------------------------------------------------------------------

# Both recorded streams, 120 ticks each at batch 1 under the flight
# configuration (400 iterations, polish, the kernels on), against the float64
# oracle of tests/golden_oracle.py on the host, at tests/test_command_
# fidelity.py's tolerances (tests/oracle_replay.py); then each tool of
# tools/*_torch.py in-process at a small size: the profilers at batch 64 with
# 3 calls a stage, the chained profiler and the benches on chains of 5 ticks
# (10 for the joint-limits latency), the recorder from tick 2, and last the
# flight, 2 s unless the phase's budget will not hold it: from the batch-1
# flight of phase 6 (its settle and ms a tick, the same path), slowed by
# as much as the recorder's 2 s settle just now took over phase 6's (the
# host's pace drifts within a run), the phase cuts the tool's seconds to
# fit FID_BUDGET_S and prints a WARNING, as phase 7 cuts ticks. The phase
# runs after the flight, which keeps FID_BUDGET_S out of its batch-64 slice
# (SCRIPT_BUDGET_S).
FID_STREAMS = {"ramp": "flight_snapshots.npz",
               "airborne": "flight_snapshots_air.npz"}
FID_TICKS, TOOL_BATCH, TOOL_ITERS, TOOL_CHAIN = 120, 64, 3, 5
TOOL_FLIGHT_S, TOOL_FLIGHT_MIN_S, TOOL_LATENCY_CHAIN = 2.0, 0.5, 10
FID_BUDGET_S = 90.0
PARTS_REL_TOL = 1e-4


def launches_all(K):
    return {"admm_segment": K.admm_segment.launches,
            "admm_segment_grouped": K.admm_segment_grouped.launches,
            "woodbury_ns": K.woodbury_ns.launches}


def phase_fidelity_tools(K, dev, record, flight_b1):
    """The recorded streams on the card against the float64 oracle; every
    tool's main at a small size, one summary line each, the flight tool last
    at what the budget holds of 2 s, judged by phase 6's batch-1 flight
    (``flight_b1``, its run_flight info)."""
    import contextlib
    import io

    for sub in ("tests", "tools"):
        if str(ROOT / sub) not in sys.path:
            sys.path.insert(0, str(ROOT / sub))
    import bench_joint_limits_latency_torch
    import bench_ns_skip_torch
    import debug_qp_torch
    import fly_full_trajectory_torch
    import make_calibrated_urdf_torch
    import oracle_replay as orp
    import profile_chained_stages_torch
    import profile_condense_torch
    import profile_solve_parts_torch
    import profile_tick_torch
    import record_flight_snapshots_torch

    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = {"streams": {}, "tools": {}, "paths": []}

    # --- a. the recorded streams against the float64 oracle ---------------
    settings = admm.ADMMSettings(max_iter=400, polish=True)
    check(settings.kernel_mode == "auto", "fidelity: the kernels are off")
    for name, fname in FID_STREAMS.items():
        path = ROOT / "tests" / "golden" / fname
        replay = load_flight_replay(path, device=dev)
        frames = orp.oracle_frames(path)
        K.reset_launches()
        t0 = time.perf_counter()
        port, orc = orp.replay_against_oracle(replay, frames, settings,
                                              FID_TICKS)
        wall = time.perf_counter() - t0
        launches = read_launches(K)
        for k, n in launches.items():
            check(n > 0, f"fidelity {name}: {k} was never launched")
        errs, same, n_upd = orp.command_errors(port, orc)
        check(all(errs[k] <= tol for k, tol in orp.RECORDED_TOL.items())
              and same and n_upd >= orp.MIN_CHANGES,
              f"fidelity {name}: the card's commands against the float64 "
              f"oracle: max errors {errs} (tolerances {orp.RECORDED_TOL}), "
              f"throttle updates on the oracle's ticks {same}, {n_upd} of "
              f"them (at least {orp.MIN_CHANGES})")
        out["streams"][name] = dict(ticks=FID_TICKS, wall_s=wall,
                                    max_err=errs, tol=orp.RECORDED_TOL,
                                    n_throttle_updates=n_upd,
                                    launches=launches)
        out["paths"].append({"launches": launches})
        print(f"[fidelity_tools] {name} stream: {FID_TICKS} ticks on the card "
              f"(kernels on) against the float64 oracle: max |card - oracle| "
              f"joints {errs['joints_pos_ref']:.3e} rad, throttle "
              f"{errs['throttle']:.3e} %, thrust {errs['thrust_des']:.3e} N, "
              f"thrust rate {errs['thrust_dot_des']:.3e} N/s (tolerances "
              f"{orp.RECORDED_TOL}); {n_upd} throttle updates, on the "
              f"oracle's ticks; launches {launches}; {wall:.1f} s")
    out["part_s"] = {"streams": time.perf_counter() - t_phase}

    # --- b. the tools ------------------------------------------------------
    def run_tool(name, module, argv, checks, summary, on_path=True):
        """``module.main(argv)`` with its output kept in the record; its
        launches join the kernels line unless they only compare kernels
        with their twins (``on_path=False``)."""
        K.reset_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec = module.main(argv)
        wall = time.perf_counter() - t0
        launches = launches_all(K)
        checks(rec, launches)
        out["tools"][name] = dict(argv=argv, wall_s=wall, launches=launches,
                                  stdout=buf.getvalue())
        if on_path:
            out["paths"].append({"launches": launches})
        print(f"[fidelity_tools] {name} {' '.join(argv)}: {summary(rec)}; "
              f"launches {launches}; {wall:.1f} s")
        return rec

    def launched(name, *kernels):
        def checks(rec, launches):
            for k in kernels:
                check(launches[k] > 0, f"{name}: {k} was never launched")
            flat = json.dumps(rec, default=str)
            check("NaN" not in flat and "Infinity" not in flat,
                  f"{name}: a number of its record is not finite")
        return checks

    main_kernels = ("admm_segment", "woodbury_ns")
    dev_arg = ["--device", str(dev)]

    def stages(r):
        return ", ".join(f"{k} {v:.3f}" for k, v in r["ms"].items()) + " ms"

    batch_args = [str(TOOL_BATCH), "--iters", str(TOOL_ITERS)] + dev_arg
    run_tool("profile_tick", profile_tick_torch, batch_args,
             launched("profile_tick", *main_kernels), stages)
    run_tool("profile_condense", profile_condense_torch, batch_args,
             launched("profile_condense"), stages)

    def parts_checks(rec, launches):
        launched("profile_solve_parts", "admm_segment",
                 "admm_segment_grouped", "woodbury_ns")(rec, launches)
        for row in rec["kernels"]:
            check(row["launches"] == row["calls"] >= TOOL_ITERS
                  and row["rel_err"] <= PARTS_REL_TOL,
                  f"profile_solve_parts: {row}")

    run_tool("profile_solve_parts", profile_solve_parts_torch, batch_args,
             parts_checks, lambda r: stages(r) + "; kernels (CUDA events) " + (
                 ", ".join(f"{k['name']} {k['ms']:.4f} ms (twin "
                           f"{k['plain_ms']:.4f}, rel err {k['rel_err']:.1e})"
                           for k in r["kernels"])), on_path=False)
    chain_args = [str(TOOL_BATCH), str(TOOL_CHAIN), "--reps", "1"] + dev_arg
    run_tool("profile_chained_stages", profile_chained_stages_torch,
             chain_args, launched("profile_chained_stages", *main_kernels),
             lambda r: ", ".join(f"{k} {v:.3f}" for k, v in
                                 r["budget_ms"].items()) + " ms; slope "
             f"{r['slope_us_per_iteration']:.1f} us/iteration")
    run_tool("bench_ns_skip", bench_ns_skip_torch, chain_args,
             launched("bench_ns_skip", *main_kernels), lambda r: ", ".join(
                 f"{k} {v:.0f}" for k, v in r["solves_per_s"].items())
             + " solves/s")

    def latency_checks(rec, launches):
        launched("bench_joint_limits_latency", *main_kernels)(rec, launches)
        modes = rec["modes"]
        check(rec["n_box"] == 120
              and all(v > 0 for v in modes["on"]["launches_per_tick"].values())
              and not any(modes["off"]["launches_per_tick"].values()),
              f"bench_joint_limits_latency: {rec}")

    run_tool("bench_joint_limits_latency", bench_joint_limits_latency_torch,
             [str(TOOL_LATENCY_CHAIN)] + dev_arg, latency_checks,
             lambda r: ", ".join(
                 f"kernel_mode={m}: p50 {v['p50_ms']:.3f} ms, solved "
                 f"{v['solved_frac']:.3f}" for m, v in r["modes"].items()))

    def dump_checks(rec, launches):
        check(len(rec) == 19 and all(np.isfinite(v).all()
                                     for v in rec.values()),
              f"debug_qp: {sorted(rec)}")

    run_tool("debug_qp", debug_qp_torch,
             [str(out_dir / "debug_qp_torch.npz")] + dev_arg, dump_checks,
             lambda r: f"{len(r)} arrays, |H| max "
             f"{np.abs(r['hessian']).max():.4g}, |g| max "
             f"{np.abs(r['gradient']).max():.4g}")
    urdf = out_dir / "ironcub_mk3_calibrated_torch.urdf"
    run_tool("make_calibrated_urdf", make_calibrated_urdf_torch,
             ["--out", str(urdf)], lambda rec, launches: check(
                 urdf.read_bytes() == (ROOT / "data" /
                                       "ironcub_mk3_calibrated.urdf"
                                       ).read_bytes(),
                 "make_calibrated_urdf: not the committed URDF"),
             lambda r: "byte-identical to data/ironcub_mk3_calibrated.urdf")
    stream = out_dir / "flight_snapshots_torch.npz"

    def stream_checks(rec, launches):
        launched("record_flight_snapshots", *main_kernels)(rec, launches)
        replay = load_flight_replay(stream, device=dev)
        check(replay.n_ticks == 3 and int(rec["meta_start_tick"][0]) == 2,
              f"record_flight_snapshots: {replay.n_ticks} ticks")

    run_tool("record_flight_snapshots", record_flight_snapshots_torch,
             ["2", "3", str(stream)] + dev_arg, stream_checks,
             lambda r: f"{r['est_td'].shape[0]} ticks from tick 2, thrust "
             f"{r['meta_thrust_range'][0]:.1f}-{r['meta_thrust_range'][1]:.1f}"
             " N, read back by runtime/replay.py")

    # the flight last, its seconds fitted to what is left of the budget
    settle_s = flight_b1["settle_wall_s"]
    tick_s = flight_b1["ms_per_tick"] / 1e3
    # the host's pace now against phase 6's: the recorder settled the same
    # 2 s as the flight tool will
    slow = max(1.0, out["tools"]["record_flight_snapshots"]["wall_s"]
               / settle_s)
    left_s = FID_BUDGET_S - (time.perf_counter() - t_phase)
    # whole twentieths of a second (10 ticks)
    n_fit = int((left_s - 1.25 * slow * settle_s - 5.0)
                / (1.25 * slow * tick_s))
    seconds = round(max(TOOL_FLIGHT_MIN_S, min(TOOL_FLIGHT_S,
                                                0.05 * (n_fit // 10))), 2)
    if seconds < TOOL_FLIGHT_S:
        print(f"[fidelity_tools] WARNING: the flight tool cut to {seconds:.2f} "
              f"of {TOOL_FLIGHT_S} s by the {FID_BUDGET_S:.0f} s budget (phase "
              f"6's batch-1 flight: settle {settle_s} s, "
              f"{flight_b1['ms_per_tick']} ms a tick; the host {slow:.2f}x "
              f"slower now)")

    def flight_checks(rec, launches):
        launched("fly_full_trajectory", *main_kernels)(rec, launches)
        check(rec["finite"] and rec["n_not_solved"] == 0
              and rec["ticks"] == int(round(seconds / 0.005)),
              f"fly_full_trajectory: {rec}")
        check(rec["device"] == card_line(), "fly_full_trajectory: device "
              f"{rec['device']!r} is not the card's line")

    run_tool("fly_full_trajectory", fly_full_trajectory_torch,
             [str(seconds), "--out",
              str(out_dir / "FLIGHT_torch_smoke.json")] + dev_arg,
             flight_checks, lambda r: (
                 f"{r['ticks']} ticks, {r['ms_per_tick']} ms/tick, CoM RMSE "
                 f"{r['com_rmse_m']} m, RPY RMSE {r['rpy_rmse_deg']} deg, "
                 f"solved {r['solved_frac']}"))

    out["part_s"]["tools"] = (time.perf_counter() - t_phase
                              - out["part_s"]["streams"])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[fidelity_tools] the phase took {out['phase_s']:.1f} s (streams "
          f"{out['part_s']['streams']:.1f}, tools {out['part_s']['tools']:.1f};"
          f" budget {FID_BUDGET_S:.0f} s)")
    check(out["phase_s"] <= FID_BUDGET_S,
          f"fidelity_tools took {out['phase_s']:.1f} s > {FID_BUDGET_S} s")
    record["fidelity_tools"] = {k: v for k, v in out.items() if k != "paths"}
    return out


# ---------------------------------------------------------------------------
# phase 7: the Monte-Carlo sweep (path C)
# ---------------------------------------------------------------------------


def sweep_reserve_s(flight_ms_per_tick):
    """Seconds to keep for the sweep phase, from the batch-64 flight's ms a
    tick (a 1024-lane sweep tick took 0.97–1.25× as long on the same host
    in the runs of PERF.md): its probe, run, profile and resume ticks with a
    margin of 1.5, and 25 s for the CPU check and the set-up."""
    ticks = 5 + SWEEP_TICKS + 2 + 2 * RESUME_TICKS
    return 1.5 * ticks * flight_ms_per_tick / 1e3 + 25.0


def _finite_stats(res):
    """Every statistic of a SweepResult is finite (a lane that diverged
    shows as +inf in lane_max_err; none is allowed to here)."""
    return all(bool(torch.isfinite(getattr(res, f).float()).all()) for f in
               ("mean_com_err", "max_com_err", "solved_frac",
                "lane_max_err"))


# a lane-tick may close SOLVED on one device and SOLVED_INACCURATE on the
# other only where each residual, primal and dual, agrees between them
# within this factor, the width of the solver's own SOLVED_INACCURATE band
# (residuals up to 10× the threshold), so that each lies within it of the
# threshold between them. The adaptive ρ divides a primal residual at
# float32 rounding, so two devices that sum in other orders leave a ρ mark
# with other ρ and their residuals part (3.1× in a run of PERF.md); the
# same rule and its reasons in tests/test_torch_sweep.py
FLIP_FACTOR = 10.0


def lane_tick_flips(a, b):
    """Hold two traced sweeps (``[ticks, lanes]`` status, primal and dual
    residual) lane-tick by lane-tick; returns the allowed flips as
    ``[tick, lane, primal a, primal b, dual a, dual b]`` rows."""
    (sa, pa, da), (sb, pb, db) = a, b
    check(sa.shape == sb.shape, f"sweep: traces {sa.shape} and {sb.shape}")
    flips = []
    for t, lane in np.argwhere(sa != sb).tolist():
        pair = {int(sa[t, lane]), int(sb[t, lane])}
        res = [float(v[t, lane]) for v in (pa, pb, da, db)]
        near = all(max(x, y) <= FLIP_FACTOR * min(x, y)
                   for x, y in (res[:2], res[2:]))
        check(pair == {1, 2} and near,
              f"sweep: lane {lane} at tick {t}: status {int(sa[t, lane])} "
              f"on the card, {int(sb[t, lane])} on the CPU, residuals "
              f"(primal, primal, dual, dual) {res}")
        flips.append([t, lane] + res)
    return flips


def phase_sweep(K, dev, record, loop, settled, channels, alpha):
    """run_sweep at 1024 scenarios from the settled, configured carry of the
    mission start (the flight phase's loop, settled state and mission
    inputs), then resume and card-against-CPU checks at 16 × 8."""
    import tempfile

    from ironcub_mpc_tpu_torch import convert
    from ironcub_mpc_tpu_torch.parallel import (
        STATUS_COLS, ScenarioConfig, make_batched_carry, run_sweep)
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.runtime import flight
    from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop

    t_phase = time.perf_counter()
    settings = dataclasses.replace(loop.settings, batch_guard=True)
    loop_s = ClosedLoop(loop.plant, loop.cfg, settings)
    check(loop_s.kd.n == 23 and loop_s.plant.lstm is not None
          and settings.kernel_mode == "auto",
          "sweep: not the 23-joint model with the LSTM jets and the kernels")
    problem, carry = loop_s.configure(settled, channels, alpha)
    scen = ScenarioConfig(wind_force_std=SWEEP_WIND_N, com_err_fail=1.0)
    batched = make_batched_carry(carry, SWEEP_SCEN, scen, seed=SWEEP_SEED)
    nu = problem.H_u.shape[-1]
    check(K._pad_to(nu) == P, f"sweep: nU {nu} does not pad to {P}")

    def sweep(n_ticks, **kw):
        res = run_sweep(loop_s, problem, batched, n_ticks, scen=scen,
                        recover=True, **kw)
        torch.cuda.synchronize()
        return res

    # a 5-tick probe (the first ticks at this batch also warm the
    # allocator) sets how many ticks fit the phase's budget
    t0 = time.perf_counter()
    sweep(5)
    probe_ms = 1e3 * (time.perf_counter() - t0) / 5
    n_ticks = min(SWEEP_TICKS, int(1e3 * SWEEP_BUDGET_S / (1.1 * probe_ms)))
    if n_ticks < SWEEP_TICKS:
        print(f"[sweep] WARNING: cut to {n_ticks} of {SWEEP_TICKS} ticks by "
              f"the {SWEEP_BUDGET_S:.0f} s budget ({probe_ms:.1f} ms a tick "
              f"in the probe); {SWEEP_SCEN} scenarios kept")
    check(n_ticks >= 10, f"sweep: {probe_ms:.1f} ms a tick leaves "
          f"{n_ticks} ticks in the budget")
    K.reset_launches()
    condensed.batch_any.syncs = 0
    t0 = time.perf_counter()
    res = sweep(n_ticks, chunk_ticks=SWEEP_CHUNK)
    wall = time.perf_counter() - t0
    launches = read_launches(K)
    syncs = condensed.batch_any.syncs
    for k, n in launches.items():
        check(n > 0, f"sweep: {k} was never launched")
    cnt = res.status_counts.cpu().numpy()
    stats = dict(
        n_scenarios=int(res.n_scenarios), n_failed=int(res.n_failed),
        n_solver_bad=int(res.n_solver_bad),
        mean_com_err=float(res.mean_com_err),
        max_com_err=float(res.max_com_err),
        solved_frac=float(res.solved_frac),
        status_counts=dict(zip(STATUS_COLS, cnt.tolist())),
        n_ticks_recovered=int(res.n_ticks_recovered),
        n_ticks_retried=int(res.n_ticks_retried),
        lane_max_err_max=float(res.lane_max_err.max()),
        lane_solver_bad=int(res.lane_solver_bad.sum()))
    check(_finite_stats(res), f"sweep: a statistic is not finite: {stats}")
    check(int(cnt[:5].sum()) == SWEEP_SCEN * n_ticks,
          f"sweep: the status histogram covers {int(cnt[:5].sum())} of "
          f"{SWEEP_SCEN * n_ticks} lane-ticks")
    check(stats["n_ticks_recovered"] <= stats["n_ticks_retried"],
          f"sweep: more ticks recovered than retried: {stats}")
    check(stats["solved_frac"] >= 0.99,
          f"sweep: solved fraction {stats['solved_frac']} < 0.99")
    # the device's busy share over one window: the first 2 ticks timed
    # without the profiler, then the same 2 ticks under it for their
    # device time
    t0 = time.perf_counter()
    sweep(2)
    wall2_ms = 1e3 * (time.perf_counter() - t0)
    prof = profile_window(lambda n: sweep(n), n=2)
    busy2 = prof["device_busy_ms"]
    prof["unprofiled_wall_ms"] = wall2_ms
    prof["busy_share_unprofiled"] = (busy2 / wall2_ms if isinstance(
        busy2, float) else "not measured")
    out = dict(scenarios=SWEEP_SCEN, ticks=n_ticks, probe_ms_per_tick=probe_ms,
               wall_s=wall, ms_per_tick=1e3 * wall / n_ticks,
               lane_ticks_per_s=SWEEP_SCEN * n_ticks / wall,
               result=stats, launches=launches,
               launches_per_tick={k: n / n_ticks for k, n in launches.items()},
               host_readbacks_per_tick=syncs / n_ticks,
               recovery_readbacks_per_tick=1.0, profile=prof)
    print(f"[sweep] {SWEEP_SCEN} scenarios x {n_ticks} ticks in {wall:.1f} s: "
          f"{out['ms_per_tick']:.3f} ms/tick, {out['lane_ticks_per_s']:.1f} "
          f"lane-ticks/s; host read-backs/tick {syncs / n_ticks:.2f} (1 of "
          f"them the recovery predicate), launches/tick "
          f"{out['launches_per_tick']}")
    print(f"[sweep] result {stats}")
    for k, v in prof["kernels"].items():
        print(f"[sweep] {k} at B = {SWEEP_SCEN}: {v['calls']} launches, mean "
              f"{v['mean_ms']:.4f} ms (profiler, {prof['ticks']} ticks)")
    print(f"[sweep] profiled {prof['ticks']} ticks: device busy "
          f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.3f} ms wall "
          f"under the profiler, of {wall2_ms:.3f} ms without it (busy share "
          f"{prof['busy_share_unprofiled']}), "
          f"{prof['device_kernels_per_tick']:.1f} device kernels/tick")

    # resume after a checkpoint against an uninterrupted run, on the card
    small = make_batched_carry(carry, RESUME_LANES, scen, seed=SWEEP_SEED + 1)

    def small_sweep(lp, pr, b, n_ticks, ck=None, trace=None):
        on_tick = None if trace is None else (lambda tel: trace.append(
            (tel.solver_status, tel.pri_res, tel.dua_res)))
        return run_sweep(lp, pr, b, n_ticks, scen=scen, recover=True,
                         chunk_ticks=RESUME_TICKS // 2, checkpoint_dir=ck,
                         on_tick=on_tick)

    card_trace, cpu_trace = [], []
    ref = small_sweep(loop_s, problem, small, RESUME_TICKS, trace=card_trace)
    with tempfile.TemporaryDirectory() as ck:
        small_sweep(loop_s, problem, small, RESUME_TICKS // 2, ck)
        resumed = small_sweep(loop_s, problem, small, RESUME_TICKS, ck)
    counts = ("n_failed", "n_solver_bad", "status_counts",
              "n_ticks_recovered", "n_ticks_retried", "lane_solver_bad")
    for f in counts:
        check(torch.equal(getattr(resumed, f), getattr(ref, f)),
              f"sweep: resumed {f} {getattr(resumed, f)} != "
              f"{getattr(ref, f)}")
    resume_err = float((resumed.lane_max_err - ref.lane_max_err).abs().max())
    check(resume_err <= 1e-6, f"sweep: resumed lane_max_err differs by "
          f"{resume_err:.3e} > 1e-6")

    # the same 16 lanes x 8 ticks through the port on the CPU
    loop_c, _, _ = flight.build_flight_loop(device="cpu")
    loop_c = ClosedLoop(loop_c.plant, loop_c.cfg, dataclasses.replace(
        loop_c.settings, batch_guard=True))
    cpu = small_sweep(loop_c, convert.to_device(problem, "cpu"),
                      convert.to_device(small, "cpu"), RESUME_TICKS,
                      trace=cpu_trace)
    # lane-tick by lane-tick: the statuses equal but SOLVED /
    # SOLVED_INACCURATE flips whose residuals agree within FLIP_FACTOR
    traces = [tuple(torch.stack(v).cpu().numpy() for v in zip(*tr))
              for tr in (card_trace, cpu_trace)]
    flips = lane_tick_flips(*traces)
    hist = [ref.status_counts.cpu(), cpu.status_counts]
    for (st, _, _), h in zip(traces, hist):
        check([int((st == c).sum()) for c in range(1, 6)] == h[:5].tolist(),
              f"sweep: a trace of {st.size} lane-ticks does not give its "
              f"histogram {h.tolist()}")
    cpu_err = float((cpu.lane_max_err - ref.lane_max_err.cpu()).abs().max())
    check(torch.equal(hist[0][2:], hist[1][2:]) and torch.equal(
        cpu.lane_solver_bad, ref.lane_solver_bad.cpu()),
          f"sweep: status histogram on the card {hist[0].tolist()} against "
          f"{hist[1].tolist()} on the CPU (lane_max_err within {cpu_err:.3e})")
    check(cpu_err <= 1e-4, f"sweep: lane_max_err card vs CPU {cpu_err:.3e} "
          "> 1e-4")
    out["resume"] = dict(lanes=RESUME_LANES, ticks=RESUME_TICKS,
                         lane_max_err_diff=resume_err,
                         status_counts=ref.status_counts.tolist())
    out["card_vs_cpu"] = dict(lane_max_err_diff=cpu_err,
                              status_counts_cpu=cpu.status_counts.tolist(),
                              flips=flips)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[sweep] resume after {RESUME_TICKS // 2} of {RESUME_TICKS} ticks "
          f"({RESUME_LANES} lanes): counts equal, lane_max_err within "
          f"{resume_err:.3e}; card vs CPU: histogram {hist[0].tolist()} "
          f"against {hist[1].tolist()}, {len(flips)} solved lane-ticks "
          f"flipped {flips}, lane_max_err within {cpu_err:.3e}; "
          f"the phase took {out['phase_s']:.1f} s")
    record["sweep"] = out
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from ironcub_mpc_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    card = card_line()
    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = K.build()
    record["build_s"] = time.perf_counter() - t0
    if "--cards" in sys.argv[1:]:
        # the parallel axes across several cards, and nothing else
        n = int(sys.argv[sys.argv.index("--cards") + 1])
        print(card)
        phase_parallel_cards(K, n, record)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"chip_smoke_cards{n}.json").write_text(
            json.dumps(record, indent=1))
        print(json.dumps({"ok": True, "cards": n}))
        return 0
    print(f"[build] nvcc {record['build_s']:.2f} s for "
          f"{sorted(reports) or 'nothing (already built)'}")
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
            if "spill stores" in line and " 0 bytes spill stores" not in line:
                print(f"[build] {name}:   (in {entry})")

    rows = phase_kernels(K, dev, record)
    seg = phase_segments(K, record)
    main_runs = phase_main(K, dev, record)
    bench = phase_bench(record)
    long_runs = phase_long_horizon(K, dev, record)
    full_space = phase_full_space(K, dev, record)
    parallel = phase_parallel(K, dev, record)
    host = phase_host_runtime(K, dev, record, main_runs)
    flights, start = phase_flight(K, dev, record)
    fid = phase_fidelity_tools(K, dev, record, flights["batch1"]["info"])
    sweep = phase_sweep(K, dev, record, *start)
    record["total_s"] = time.perf_counter() - T_START

    # one entry per kernel. The tick kernels at the batch-256 main-path
    # shape: the ADMM chunk of term_check_every=5 iterations, and the
    # Woodbury refresh with one Newton–Schulz step (the polish operator,
    # n_ns=0, is in the record); the grouped segment at the head-to-head
    # shape. Launches: the sum over the paths that run the kernel.
    pick = {"admm_segment": dict(batch=BATCH, length=5, P=P, forced=False),
            "admm_segment_grouped": dict(batch=SEG_BATCH, length=SEG_ITERS,
                                         group=GROUP),
            "woodbury_ns": dict(batch=BATCH, P=P, box0=BOX0, n_ns=1,
                                forced=False)}
    replaces = {
        "admm_segment": "ironcub_mpc_tpu/ops/pallas_solve.py:108",
        "admm_segment_grouped": "ironcub_mpc_tpu/ops/pallas_solve.py:163",
        "woodbury_ns": "ironcub_mpc_tpu/ops/pallas_solve.py:276"}
    paths = [seg] + list(main_runs.values()) + list(bench.values()) \
        + list(long_runs.values()) \
        + [v for v in full_space.values()
           if isinstance(v, dict) and "launches" in v] \
        + [parallel["pipeline"], host["driver"]] + fid["paths"] \
        + list(flights.values()) + [sweep]
    line = []
    for name, sel in pick.items():
        r = next(r for r in rows if r["name"] == name
                 and all(r.get(k) == v for k, v in sel.items()))
        line.append(dict(
            name=name, route="cuda",
            source=f"ironcub_mpc_tpu_torch/csrc/{name}.cu",
            replaces=replaces[name],
            launches=sum(m["launches"].get(name, 0) for m in paths),
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["name"] == name),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(f"[total] {record['total_s']:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
