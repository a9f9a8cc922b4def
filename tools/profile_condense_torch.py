#!/usr/bin/env python
"""Condense-stage roofline of the PyTorch port: the F/f chain apart from the
H/q contraction (counterpart of tools/profile_condense.py).

Usage: python tools/profile_condense_torch.py [batch=512] [--iters 20]
           [--device cuda]

Variants, at the first tick of the hover state of
``examples/realtime_driver_torch.hover_setup`` repeated over ``batch``
lanes, each timed on the host clock over ``--iters`` calls between two
synchronisations:

  sequential-full  condense(condense_mode="sequential")   (shipped default)
  structured-full  condense(condense_mode="structured")
  paired-full      condense(condense_mode="paired")
  chain-seq        the 17-step dense chain alone, written out
  chain-struct     the structured recurrences alone
  chain-paired     the paired chain alone
  H-einsum         the H_c/q_c contraction alone (given F, f)
  H-gemm           the same contraction as one reshaped matmul

Prints ms per call and the effective TFLOP/s of each variant's float32
operations. Runs on ``cuda`` unless ``--device`` says otherwise; ends with
one JSON line of the times and ``"device"``, the card's name and power
limit.
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

    import torch

    from ironcub_mpc_tpu_torch.core.types import expand_lanes
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc

    cfg, sched, sel, settings, problem, carry, snap, est = batched_hover(
        1, device=option(argv, "device"), jitter=0.0)
    carry2, prep = vs_mpc._tick_prep(cfg, sel, problem, carry, snap, est)
    carries, preps = expand_lanes(carry2, batch), expand_lanes(prep, batch)
    dev = carry.warm_x.device
    nU = condensed.n_inputs(cfg)
    ns, nj, nt, ch, N = (cfg.n_states, cfg.n_ctrl_joints, cfg.n_jets,
                         cfg.control_horizon, cfg.n_iter)
    print(f"# condense roofline, batch={batch}, {iters} calls each, "
          f"device={device_entry(dev)}", flush=True)
    ms = {}

    def bench(name, fn, flop_per_item=0.0):
        out = fn()
        ms[name] = host_ms(fn, dev, iters, warmup=0)
        dt = ms[name] / 1e3
        tfps = batch * flop_per_item / dt / 1e12 if flop_per_item else 0.0
        print(f"{name:16s} {ms[name]:8.3f} ms  ({batch / dt:9.0f}/s)"
              + (f"  {tfps:6.2f} TFLOP/s" if flop_per_item else ""),
              flush=True)
        return out

    # operations per solve: the chain N·2·ns²·nU (Ad @ F), H 2·(N·18)·nU²
    FLOP_CHAIN = N * 2 * ns * ns * nU
    FLOP_H = 2 * (N * 18) * nU * nU

    for mode in ("sequential", "structured", "paired"):
        mcfg = dataclasses.replace(cfg, condense_mode=mode)
        bench(f"{mode[:10]}-full", lambda m=mcfg: vs_mpc.condense_from_prep(
            m, sched, sel, problem, carries, preps), FLOP_CHAIN + FLOP_H)

    lin, x0 = preps.lin, preps.x0

    def chain_seq():
        eye = torch.eye(ns, dtype=lin.Ac.dtype, device=dev)
        F = torch.zeros((batch, ns, nU), dtype=lin.Ac.dtype, device=dev)
        f = x0
        Fs, fs = [], []
        for k in range(N):
            dtk = float(sched.dts[k])
            Ad = eye + dtk * lin.Ac
            Mk = torch.zeros((batch, ns, nU), dtype=lin.Ac.dtype, device=dev)
            jc = sched.joint_knot_of_step[k] * nj
            Mk[:, :, jc:jc + nj] += dtk * lin.BJ
            tc = nj * ch + sched.throttle_knot_of_step[k] * nt
            Mk[:, :, tc:tc + nt] += dtk * lin.BT
            F = Ad @ F + Mk
            f = (Ad @ f[..., None])[..., 0] + dtk * lin.c
            Fs.append(F)
            fs.append(f)
        return torch.stack(Fs, 1), torch.stack(fs, 1)

    F_all, f_all = bench("chain-seq", chain_seq, FLOP_CHAIN)
    bench("chain-struct", lambda: condensed._structured_chain(
        cfg, sched, lin, x0), FLOP_CHAIN)
    bench("chain-paired", lambda: condensed._paired_chain(
        cfg, sched, lin, x0), FLOP_CHAIN)

    w_idx = torch.as_tensor(condensed.weighted_state_indices(cfg),
                            device=dev)
    q_diag = torch.diagonal(problem.Q)
    Fw = F_all[:, :, w_idx, :]
    qw = q_diag[w_idx]
    r = (f_all - preps.state_ref.mT)[:, :, w_idx]

    def h_einsum():
        H = torch.einsum("bkan,a,bkam->bnm", Fw, qw, Fw)
        q = torch.einsum("bkan,a,bka->bn", Fw, qw, r)
        return H, q

    def h_gemm():
        Fl = Fw.reshape(batch, -1, nU)
        qt = qw.repeat(N)
        H = Fl.mT @ (qt[:, None] * Fl)
        q = (Fl.mT @ (qt * r.reshape(batch, -1))[..., None])[..., 0]
        return H, q

    bench("H-einsum", h_einsum, FLOP_H)
    bench("H-gemm", h_gemm, FLOP_H)
    record = {"tool": "profile_condense", "batch": batch, "iters": iters,
              "ms": ms, "device": device_entry(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
