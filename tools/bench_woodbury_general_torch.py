#!/usr/bin/env python
"""The general route of ``woodbury_ns`` on a CUDA card, choice by choice.

``ops/kernels.woodbury_general_plan`` chooses three things for a call: the
products' tile edge (32 or 64), the elimination's cluster (1, 2, 4 or 8
blocks) and whether M lives in the cluster's shared memory or in the device
scratch. At each shape of ``chip_smoke.py``'s phase 2 (P = 256 with a box of
132, a control horizon of 13 with joint limits; P = 384, 640 and 1152) this
tool runs the plan's choice and every other choice the launcher takes,
holds each against the plain twin (1e-5, exactly symmetric), times each on
CUDA events with the stream held busy (``common_torch.event_ms``), and
splits the plan's choice into its device kernels with ``torch.profiler``.
``torch.linalg.inv_ex`` of K(ρ_new) stands beside each shape as the
yardstick.

Usage: python tools/bench_woodbury_general_torch.py [--reps 20]
       [--out FILE.json] [--device cpu]

One line a choice and one JSON line at the end with ``"device"`` (the
card's name and power limit). With ``--device cpu`` it runs the twin at a
small shape and prints the plans: a dry run, no kernel.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from common_torch import device_entry, event_ms, option, writable  # noqa

from ironcub_mpc_tpu_torch.ops import kernels  # noqa: E402

SIGMA = 1e-6
TOL = 1e-5
# (P, nU, box0, batch, n_ns): chip_smoke.py's general-route rows
SHAPES = [(256, 132, 0, 1, 0), (256, 132, 0, 1, 1), (256, 132, 0, 64, 0),
          (256, 132, 0, 64, 1), (384, 288, 208, 1, 1),
          (640, 528, 520, 1, 1), (640, 528, 520, 16, 1),
          (640, 528, 0, 1, 0), (1152, 1140, 1132, 1, 0),
          (1152, 1140, 1132, 1, 1), (1152, 1140, 1008, 1, 0),
          (1152, 1140, 1008, 1, 1)]
CPU_SHAPES = [(256, 132, 0, 2, 1)]


def inputs(p, nu, box0, batch, dev, seed=3):
    """K⁻¹(ρ_old) of a seeded SPD H, H, d = ρ_new − ρ_old and ρ_new, padded
    to P; and K(ρ_new) [B, nU, nU] for the yardstick."""
    rng = np.random.default_rng(seed)
    nb = nu - box0
    M = rng.normal(size=(batch, nu, nu))
    H = M @ M.transpose(0, 2, 1) / nu + np.eye(nu)
    rho_old = np.abs(rng.normal(size=(batch, nb))) + 0.1
    rho_new = rho_old * rng.uniform(0.2, 5.0, (batch, nb))
    full = np.zeros((batch, nu))
    full[:, box0:] = rho_old
    K_old = H + SIGMA * np.eye(nu) + full[:, None, :] * np.eye(nu)
    Ki = np.linalg.inv(K_old)
    Ki = 0.5 * (Ki + Ki.transpose(0, 2, 1))
    pad = ((0, 0), (0, p - nu), (0, p - nu))

    def vec(v):
        out = np.zeros((batch, p))
        out[:, box0:nu] = v
        return out

    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    full[:, box0:] = rho_new
    K_new = H + SIGMA * np.eye(nu) + full[:, None, :] * np.eye(nu)
    return ([t(np.pad(Ki, pad)), t(np.pad(H, pad)), t(vec(rho_new - rho_old)),
             t(vec(rho_new))], t(K_new))


def choices(batch, p, n_box, n_ns):
    """Every (tile, cluster, in shared memory) the launcher takes here."""
    out = []
    for tile in kernels.WOODBURY_GENERAL_TILES:
        for c in kernels.WOODBURY_GJ_CLUSTERS:
            for in_smem in (True, False):
                if kernels.woodbury_general_gj_smem_bytes(
                        n_box, c, in_smem) <= kernels.MAX_SMEM:
                    out.append(dict(tile=tile, gj_cluster=c,
                                    gj_in_smem=in_smem))
    return out


def run(ins, plan, box0, n_box, n_ns):
    """One call of the general route's launches as ``plan`` says."""
    B, p = ins[0].shape[0], ins[0].shape[-1]
    out = torch.empty_like(ins[0])
    lib = kernels._lib("woodbury_ns")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in ins + [out]]
    rc = kernels._general_launch(lib, ptrs, plan, B, p, box0, n_box, SIGMA,
                                 n_ns, ins[0].device, stream)
    kernels._raise_on(rc, "woodbury_ns")
    return out


def kernel_split(fn, reps=20):
    """Device ms of each of the route's kernels a call, from torch.profiler
    over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        found = re.search(r"woodbury_ns_general_(\w+(<[^>]*>)?)", ev.key)
        if found:
            split[found[1]] = split.get(found[1], 0.0) + \
                ev.self_device_time_total / 1e3 / reps
    return split


def main(argv):
    dev = torch.device(option(argv, "device", "cuda"))
    reps = int(option(argv, "reps", 20))
    out_path = option(argv, "out")
    out_path = None if out_path is None else writable(out_path)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_woodbury_general_torch: no CUDA device (pass --device "
              "cpu for a dry run)", file=sys.stderr)
        return 2
    records = []
    for p, nu, box0, batch, n_ns in (SHAPES if dev.type == "cuda"
                                     else CPU_SHAPES):
        nb = nu - box0
        ins, K_new = inputs(p, nu, box0, batch, dev)
        kw = dict(box0=box0, n_box=nb, sigma=SIGMA, n_ns=n_ns)
        ref = kernels.woodbury_ns_plain(*ins, **kw)
        plan = kernels.woodbury_plan(batch, p, nb, n_ns)
        shape = f"P={p} n_box={nb} B={batch} n_ns={n_ns}"
        rec = dict(P=p, n_box=nb, batch=batch, n_ns=n_ns,
                   plan={k: plan[k] for k in ("tile", "cluster",
                                              "gj_in_smem", "kernels",
                                              "blocks")},
                   library_ms=event_ms(lambda: torch.linalg.inv_ex(K_new),
                                       dev, reps))
        if dev.type != "cuda":
            rec["plain_ms"] = event_ms(
                lambda: kernels.woodbury_ns_plain(*ins, **kw), dev, 2)
            print(f"[bench_woodbury_general] {shape}: plan {rec['plan']}, "
                  f"twin {rec['plain_ms']:.4f} ms (host clock, CPU)")
            records.append(rec)
            continue
        rec["choices"] = []
        for force in choices(batch, p, nb, n_ns):
            alt = kernels.woodbury_general_plan(batch, p, nb, n_ns, **force)
            got = run(ins, alt, box0, nb, n_ns)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= TOL \
                and torch.equal(got, got.mT)
            ms = event_ms(lambda: run(ins, alt, box0, nb, n_ns), dev, reps)
            chosen = all(alt[k] == plan[k] for k in
                         ("tile", "cluster", "gj_in_smem"))
            rec["choices"].append(dict(force, ms=ms, max_abs_err=err, ok=ok,
                                       chosen=chosen))
            print(f"[bench_woodbury_general] {shape}: tile {force['tile']} "
                  f"cluster {force['gj_cluster']} M in "
                  f"{'shared memory' if force['gj_in_smem'] else 'scratch'}"
                  f"{' (plan)' if chosen else ''}: {ms:.4f} ms, err "
                  f"{err:.2e}{'' if ok else '  FAILED'}")
        rec["split_ms"] = kernel_split(
            lambda: run(ins, plan, box0, nb, n_ns))
        print(f"[bench_woodbury_general] {shape}: inv_ex "
              f"{rec['library_ms']:.4f} ms; plan's kernels "
              + ", ".join(f"{k} {v:.4f}" for k, v in rec["split_ms"].items()))
        records.append(rec)
    result = dict(device=device_entry(dev), records=records)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(device=result["device"], ok=all(
        c["ok"] for r in records for c in r.get("choices", ())))))
    return 0 if all(c["ok"] for r in records
                    for c in r.get("choices", ())) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
