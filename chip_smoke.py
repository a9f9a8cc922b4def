#!/usr/bin/env python3
"""Drive the PyTorch port of the multi-rate MPC on one CUDA card: the
condensed tick on the recorded stream, the segment head-to-head and the
closed-loop flight.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build     compile every CUDA kernel (one nvcc per source, started
             together) into build/torch_kernels/.
2. kernels   run each kernel against its plain PyTorch twin on the same
             CUDA tensors at the shapes its path gives it; time kernel,
             twin, the card's bound and, where one exists, a single PyTorch
             call that computes the same function. Every variant a wrapper
             can choose (admm_segment: K⁻¹ in registers at P = 128, streamed
             through L2 at P = 256; woodbury_ns: one block or a cluster of 8
             at P = 128, a cluster of 8 at P = 256) is held against the twin
             and timed as well, at batch 1, 64 and 256, and woodbury_ns's
             general route (one block a scenario, a device scratch) at the
             shapes the tuned routes do not take: P = 256 with n_box 132 (a
             control horizon of 13 with joint limits), P = 384 and P = 640.
             The previous design's times stand beside the new ones, and the
             script fails where a kernel is more than 10 % slower than its
             previous design at a main-path shape, or where woodbury_ns at
             n_box 120 loses to torch.linalg.inv_ex. The grouped segment
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
5. long_horizon  the recorded stream under MPCConfig(control_horizon=13,
             use_joint_position_constraint=True): nU = 132 pads to P = 256
             with the box over all 132 inputs, so the refresh takes
             woodbury_ns's general route; 10 ticks at batch 1 and 10 at
             batch 64, every lane solved, the first 5 against the port's
             CPU run.
6. flight    the closed loop at full width (23-joint calibrated Mk3 model,
             LSTM+EKF jets, mission trajectories, flight solver settings):
             batch 1 through ``run_flight`` (2 s settle, 400 ticks) with
             the per-layer split, a profiled window and a comparison of the
             first 20 ticks with the port's CPU run from the same settled
             state; batch 64 with batch-wide decisions and a numpy-seeded
             wind per lane over the first 20 s of the mission (4000 ticks,
             fewer if the time budget says so), ``flight_stats`` per lane
             and the flight-regression bounds on the wind-free lane 0.

Launch counters are zeroed just before each path is driven and read just
after; every kernel of a path must have launched in it. Prints the card's
name and power limit, one JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``. The full record goes to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
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
# a long horizon with joint limits: nU = 8·13 + 4·7 = 132 -> P = 256, n_box 132
LONG_HORIZON = dict(control_horizon=13, use_joint_position_constraint=True)
LH_TICKS, LH_CHECK, LH_BATCH = 10, 5, 64
# the head-to-head shape of the grouped segment, and the tick's chunk shape
SEG_BATCH, SEG_ITERS, GROUP = 512, 40, 8
# (batch, length, group, P) of the grouped rows: every group at the
# head-to-head shape, the tick's chunk at batch 1, 64 and 256 (beside
# admm_segment's 4 × 8 layout), four waves (B = 1056), P = 256
GROUPED_SHAPES = [(SEG_BATCH, SEG_ITERS, g, P) for g in (1, 4, 8, 16)] + [
    (1, 5, 1, P), (64, 5, 1, P), (BATCH, 5, GROUP, P),
    (1056, SEG_ITERS, GROUP, P), (64, 5, GROUP, P2)]
# (P, nU, box0, batches, n_ns) of woodbury_ns's general route
WOODBURY_GENERAL = [(P2, 132, 0, (1, 64), (0, 1)), (384, 288, 208, (1,), (1,)),
                    (640, 528, 520, (1, 16), (1,)), (640, 528, 0, (1,), (0,))]
# closed-loop flight: 2 s at batch 1; the first 20 s of the mission at batch
# 64 unless the whole script would pass FLIGHT_DEADLINE_S
FLIGHT_B1_S, FLIGHT_SETTLE_S = 2.0, 2.0
FLIGHT_BATCH, FLIGHT_SLICE_S, WIND_STD_N = 64, 20.0, 2.0
FLIGHT_DEADLINE_S = 600.0

# Device ms of the previous designs of admm_segment (K⁻¹ in shared memory, one
# thread per coordinate) and woodbury_ns (intermediates in a device-memory
# scratch, one block of 4 × 4 register tiles per scenario), run H of PERF.md,
# and of admm_segment_grouped (one block of 8 scenarios, 55 rows of each K⁻¹
# resident, the rest streamed from L2), run L, from this script's phase 2 on
# PREVIOUS_CARD, keyed by batch; the new designs are held to them at the
# main path's shapes and the grouped kernel's two timed shapes.
PREVIOUS_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PREVIOUS_MS = {
    ("admm_segment", 5): {1: 0.0129, 64: 0.0132, 256: 0.0142},
    ("woodbury_ns", 24, 1): {1: 0.1836, 64: 0.1857, 256: 0.3095},
    ("woodbury_ns", 24, 0): {1: 0.0625, 64: 0.0634, 256: 0.0969},
    ("woodbury_ns", 120, 1): {256: 2.547},
    ("admm_segment_grouped", 8): {512: 0.2628, 256: 0.0389},
}
SLOWER_THAN_PREVIOUS = 1.10


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
    if row["P"] != P:
        return None
    if row["name"] == "admm_segment":
        key = ("admm_segment", row["length"])
    elif row["name"] == "admm_segment_grouped":
        key = ("admm_segment_grouped", row["group"])
    else:
        key = ("woodbury_ns", row["n_box"], row["n_ns"])
    return PREVIOUS_MS.get(key, {}).get(row["batch"])


def segment_row(K, ins, batch, length, p=P):
    """One admm_segment row: the kernel against the twin, its time and its
    bound."""
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=length)
    got = K.admm_segment(*ins, **kw)
    ref = K.admm_segment_plain(*ins, **kw)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    tol = 1e-4
    variant = K.segment_plan(batch, p)["variant"]
    ok = all(bool(torch.isfinite(a).all()) for a in got)
    check(ok and err <= tol, f"admm_segment B={batch} P={p} L={length} "
          f"{variant}: err {err:.3e} > {tol}")
    bms, by = segment_bound(batch, length, p)
    return dict(
        name="admm_segment", batch=batch, length=length, P=p, variant=variant,
        forced=False, max_abs_err=err, tol=tol,
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
    bms, by = woodbury_bound(batch, nb, n_ns, p)
    return dict(
        name="woodbury_ns", batch=batch, P=p, box0=box0, n_box=nb, n_ns=n_ns,
        route=plan["route"], cluster=plan["cluster"],
        forced=cluster is not None, max_abs_err=err, tol=tol,
        ms=cuda_ms(lambda: K.woodbury_ns(*ins, cluster=cluster, **kw)),
        plain_ms=None, bound_ms=bms, bound_by=by, library_ms=None)


def phase_kernels(K, dev, record):
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
        rows.append(segment_row(K, ins, batch, 5, p=P2))
    tuned = [(p, nu, box0, (1, FLIGHT_BATCH, BATCH), (0, 1))
             for p, nu, box0 in ((P, NU, BOX0), (P, NU, 0), (P2, NU2, BOX02))]
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
                          ("batch", "length", "group", "P", "variant", "route",
                           "box0", "n_box", "n_ns", "cluster") if k in r)
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
                         or r["n_box"] == NU - BOX0)
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
    wide = next(r for r in rows if r["name"] == "woodbury_ns"
                and not r["forced"] and r["batch"] == BATCH and r["P"] == P
                and r["n_box"] == NU and r["n_ns"] == 1)
    check(wide["ms"] <= wide["library_ms"],
          f"woodbury_ns at n_box {NU}, batch {BATCH}: {wide['ms']:.4f} ms "
          f"loses to torch.linalg.inv_ex, {wide['library_ms']:.4f} ms")
    record["kernels"] = rows
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
    for batch, length, group, p in GROUPED_SHAPES:
        nu, box0 = (NU, BOX0) if p == P else (NU2, BOX02)
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
        variant = K.grouped_plan(batch, p, group)["variant"]
        check(ok and err <= tol and err1 <= tol,
              f"admm_segment_grouped B={batch} L={length} G={group} P={p} "
              f"{variant}: err {err:.3e} (twin), {err1:.3e} (admm_segment) "
              f"> {tol}")
        bms, by = segment_bound(batch, length, p)
        rows.append(dict(
            name="admm_segment_grouped", batch=batch, length=length,
            group=group, P=p, variant=variant, forced=False, max_abs_err=err,
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
              per_tick_sync=False):
    """Chain ``n_ticks`` replay ticks; returns (carry, outputs on the host,
    per-tick host times in ms)."""
    from ironcub_mpc_tpu_torch.core.types import expand_lanes

    dev = replay.est_td.device
    jit = None if jitter is None else torch.as_tensor(jitter, device=dev)
    c = expand_lanes(carry, batch)
    outs, times = [], []
    for t in range(n_ticks):
        snap, est = replay.tick_inputs(t, batch, jit)
        t0 = time.perf_counter()
        c, out = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel, settings,
                              problem, c, snap, est)
        if per_tick_sync:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        outs.append(out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    host = [{k: getattr(o, k).cpu().numpy() for k in
             ("joints_pos_ref", "throttle", "thrust_des", "final_state",
              "status", "guard_fired")} for o in outs]
    return c, host, times


def compare_streams(gpu, cpu, tol, what):
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
        out[name] = dict(batch=batch, ticks=LH_TICKS, nU=nu, P=p, n_box=nb,
                         ms_per_tick_first_included=wall_ms / LH_TICKS,
                         launches=launches, solved_frac=solved,
                         max_err_vs_cpu=worst)
        print(f"[long_horizon] {name}: nU {nu} (P {p}, n_box {nb}), "
              f"{LH_TICKS} ticks, solved fraction {solved}, launches "
              f"{launches}, {wall_ms / LH_TICKS:.3f} ms/tick (first tick "
              f"included), max err vs CPU over {LH_CHECK} ticks {worst}")
    record["long_horizon"] = out
    return out


def profile_window(run, n=10):
    """torch.profiler over ``run(n)``, which drives ``n`` ticks: the device's
    busy time and kernel count (every event that ran on the card), the two
    kernels' device time, the host calls that wait for the device, and the
    heaviest device kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_card = [ev for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in on_card)
    # a wrapper's launches, over every instantiation of its kernel
    ours = {}
    for ev in on_card:
        for name, marks in (("admm_segment", ("admm_segment_reg_kernel",
                                              "admm_segment_streamed_kernel")),
                            ("woodbury_ns", ("woodbury_ns_kernel",
                                             "woodbury_ns_general_kernel"))):
            if any(m in ev.key for m in marks):
                k = ours.setdefault(name, dict(calls=0, total_ms=0.0))
                k["calls"] += ev.count
                k["total_ms"] += ev.self_device_time_total / 1e3
    for k in ours.values():
        k["mean_ms"] = k["total_ms"] / k["calls"]
    waits = {ev.key: ev.count for ev in events
             if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "aten::item", "cudaMemcpyAsync")}
    top_dev = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    top_host = sorted((ev for ev in events
                       if ev.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:8]
    return dict(
        ticks=n, wall_ms=wall,
        device_busy_ms=busy_us / 1e3 if on_card else "not measured",
        device_busy_share=(busy_us / 1e3 / wall if on_card
                           else "not measured"),
        device_kernels_per_tick=sum(ev.count for ev in on_card) / n,
        kernels=ours, host_waits=waits,
        top_device=[(ev.key[:60], ev.count, ev.self_device_time_total / 1e3)
                    for ev in top_dev],
        top_host=[(ev.key[:60], ev.count, ev.self_cpu_time_total / 1e3)
                  for ev in top_host])


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
    left_s = FLIGHT_DEADLINE_S - (time.perf_counter() - T_START) - 20.0
    full = int(round(FLIGHT_SLICE_S / period))
    n_ticks = max(200, min(full, int(1e3 * left_s / (1.1 * probe_ms))))
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
    print(f"[build] nvcc {record['build_s']:.2f} s for "
          f"{sorted(reports) or 'nothing (already built)'}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    rows = phase_kernels(K, dev, record)
    seg = phase_segments(K, record)
    main_runs = phase_main(K, dev, record)
    long_runs = phase_long_horizon(K, dev, record)
    flights = phase_flight(K, dev, record)
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
    paths = [seg] + list(main_runs.values()) + list(long_runs.values()) \
        + list(flights.values())
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
