#!/usr/bin/env python
"""The cluster and spread routes of ``admm_segment`` on a CUDA card, choice
by choice.

``ops/kernels.segment_plan`` chooses, for every padded size but 128, how a
scenario's mat-vec x̃ = rhs·K⁻¹ is spread: over a cluster of C blocks (1, 2,
4 or 8), each holding a column strip of K⁻¹ in shared memory or, at
P = 256, in registers; or over the whole card, 32, 16 or 8 columns a
block, in one launch an iteration ("spread"). At the shapes of
``chip_smoke.py``'s phase 2 (P = 256 at batch 1, 64 and 256 — the long
horizon's segment — P = 640, P = 1152 and P = 4224 at batch 1) this tool
runs the plan's choice and every other choice the launcher takes (every
cluster size, K⁻¹ in registers or in shared memory, every strip width of
the spread route), holds each against the plain twin (1e-4) on a seeded
proper inverse, and times each on CUDA events with the stream held busy
(``common_torch.event_ms``).

Then it splits a step of the plan's cluster at P = 256, batch 1: the
segment is timed at lengths 1 and 41, and so is a build of the same source
with ``-DADMM_SEGMENT_NO_MATVEC`` (nvcc into ``build/torch_kernels/``,
git-ignored), whose step keeps the cluster barrier, the rhs exchange, the
reduction and the update and skips the mat-vec. The slopes give a step's
microseconds with and without the mat-vec.

Usage: python tools/bench_segment_streamed_torch.py [--reps 50]
       [--out FILE.json] [--device cpu]

One line a choice and one JSON line at the end with ``"device"`` (the
card's name and power limit). With ``--device cpu`` it runs the twin at a
small shape and prints the plans: a dry run, no kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from common_torch import device_entry, event_ms, option, writable  # noqa

from ironcub_mpc_tpu_torch.ops import kernels  # noqa: E402

SIGMA, ALPHA, LENGTH = 1e-6, 1.6, 5
TOL = 1e-4
# (P, batch): chip_smoke.py's segment rows on these routes
SHAPES = [(256, 1), (256, 64), (256, 256), (640, 1), (1152, 1), (4224, 1)]
CPU_SHAPES = [(256, 2)]
# the step split: lengths timed, at P = 256, batch 1
SPLIT_LENGTHS = (1, 41)
PLAN_KEYS = ("route", "cluster", "kinv_in_registers", "spread_cols",
             "blocks", "threads", "smem_bytes", "kernels")


def inputs(p, batch, dev, seed=5, n_box=134):
    """The segment's nine operands at padded size P for nU = P − 16 inputs,
    the box on the last ``n_box`` of them: K⁻¹ the inverse of H + σI +
    diag(ρ), H = MMᵀ/nU + I of a seeded normal M, made on ``dev`` in
    float64 (so the iterates stay O(1) and the twin's 1e-4 holds)."""
    nu = p - 16
    box0 = nu - n_box
    rng = np.random.default_rng(seed)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                    device=dev)
    M = f64(rng.normal(size=(batch, nu, nu)))
    rho = np.abs(rng.normal(size=(batch, n_box))) + 0.1
    rho_full = np.zeros((batch, nu))
    rho_full[:, box0:] = rho
    eye = torch.eye(nu, dtype=torch.float64, device=dev)
    Ki = torch.linalg.inv(M @ M.mT / nu + (1.0 + SIGMA) * eye
                          + torch.diag_embed(f64(rho_full)))
    Ki = torch.nn.functional.pad(0.5 * (Ki + Ki.mT), (0, p - nu, 0, p - nu))

    def vec(v=None, fill=0.0):
        out = np.full((batch, p), fill)
        out[:, nu:] = 0.0
        out[:, box0:nu] = rng.normal(size=(batch, n_box)) if v is None else v
        return f64(out)

    full = lambda: f64(np.pad(rng.normal(size=(batch, nu)),  # noqa: E731
                              ((0, 0), (0, p - nu))))
    raw = [Ki, full(), vec(-np.abs(rng.normal(size=(batch, n_box))), -1e20),
           vec(np.abs(rng.normal(size=(batch, n_box))), 1e20), vec(rho),
           vec(1.0 / rho), full(), vec(), vec()]
    return [a.float().contiguous() for a in raw]


def choices(batch, p):
    """Every (cluster, K⁻¹ in registers) the launcher takes at P, and the
    spread route's strip widths."""
    out = [dict(cluster=0, spread_cols=w)
           for w in kernels.SEGMENT_SPREAD_WIDTHS]
    for c in kernels.SEGMENT_CLUSTERS:
        for regs in (False, True):
            if kernels.segment_cluster_takes(p, c, regs):
                out.append(dict(cluster=c, kinv_in_registers=regs))
    return out


def variant_lib(define: str):
    """``csrc/admm_segment.cu`` built with ``-D<define>`` beside the
    committed library, bound as the wrapper binds it."""
    src = kernels.CSRC / kernels.SOURCES["admm_segment"]
    out = kernels._lib_path("admm_segment").with_suffix(f".{define}.so")
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                               f"-D{define}", "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc -D{define} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.admm_segment_launch.restype = ctypes.c_int
    lib.admm_segment_launch.argtypes = kernels.SEGMENT_ARGTYPES[
        "admm_segment"]
    return lib


def run_lib(lib, ins, plan, length):
    """One launch of ``lib``'s segment as ``plan`` says."""
    B, p = ins[0].shape[0], ins[0].shape[-1]
    outs = [torch.empty_like(ins[6]) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.admm_segment_launch(
        *(t.data_ptr() for t in (*ins, *outs)), None, B, p, SIGMA, ALPHA,
        1.0 - ALPHA, length, plan["cluster"], int(plan["kinv_in_registers"]),
        plan["spread_cols"], stream)
    kernels._raise_on(rc, "admm_segment")
    return outs


def step_split(ins, plan, dev, reps):
    """µs of a step with and without its mat-vec, from the slope of the
    segment's time over SPLIT_LENGTHS, for ``plan`` (a cluster)."""
    full = kernels._lib("admm_segment")
    bare = variant_lib("ADMM_SEGMENT_NO_MATVEC")
    lo, hi = SPLIT_LENGTHS
    out = {}
    for name, lib in (("step", full), ("without_matvec", bare)):
        t = [event_ms(lambda n=n: run_lib(lib, ins, plan, n), dev, reps)
             for n in (lo, hi)]
        out[f"{name}_us"] = 1e3 * (t[1] - t[0]) / (hi - lo)
        out[f"{name}_length{lo}_ms"] = t[0]
    out["matvec_us"] = out["step_us"] - out["without_matvec_us"]
    return out


def main(argv):
    dev = torch.device(option(argv, "device", "cuda"))
    reps = int(option(argv, "reps", 50))
    out_path = option(argv, "out")
    out_path = None if out_path is None else writable(out_path)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_segment_streamed_torch: no CUDA device (pass --device "
              "cpu for a dry run)", file=sys.stderr)
        return 2
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=LENGTH)
    records, ok = [], True
    for p, batch in (SHAPES if dev.type == "cuda" else CPU_SHAPES):
        ins = inputs(p, batch, dev)
        ref = kernels.admm_segment_plain(*ins, **kw)
        plan = kernels.segment_plan(batch, p, LENGTH)
        shape = f"P={p} B={batch}"
        rec = dict(P=p, batch=batch, length=LENGTH,
                   plan={k: plan[k] for k in PLAN_KEYS},
                   plain_ms=event_ms(
                       lambda: kernels.admm_segment_plain(*ins, **kw), dev,
                       max(2, reps // 5)))
        if dev.type != "cuda":
            print(f"[bench_segment_streamed] {shape}: plan {rec['plan']}, "
                  f"twin {rec['plain_ms']:.4f} ms (host clock, CPU)")
            records.append(rec)
            continue
        rec["choices"] = []
        for force in choices(batch, p):
            alt = kernels.segment_plan(batch, p, LENGTH, **force)
            got = kernels._segment_launch("admm_segment", ins, alt, **kw)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            good = all(bool(torch.isfinite(g).all()) for g in got) \
                and err <= TOL
            ok &= good
            ms = event_ms(lambda: kernels._segment_launch(
                "admm_segment", ins, alt, **kw), dev, reps)
            chosen = all(alt[k] == plan[k] for k in
                         ("route", "cluster", "kinv_in_registers",
                          "spread_cols"))
            rec["choices"].append(dict(
                force, ms=ms, max_abs_err=err, ok=good, chosen=chosen,
                kernels=alt["kernels"]))
            where = (f"spread, {alt['spread_cols']} columns a block"
                     if alt["route"] == "spread" else
                     f"cluster {alt['cluster']}, K⁻¹ in "
                     + ("registers" if alt["kinv_in_registers"] else
                        "shared memory"))
            print(f"[bench_segment_streamed] {shape}: {where}"
                  f"{' (plan)' if chosen else ''}: {ms:.4f} ms, err "
                  f"{err:.2e}{'' if good else '  FAILED'}")
        if (p, batch) == (256, 1):
            rec["step_split"] = step_split(ins, plan, dev, reps)
            s = rec["step_split"]
            print(f"[bench_segment_streamed] {shape}: a step of the plan's "
                  f"cluster {s['step_us']:.3f} µs, of which the mat-vec "
                  f"{s['matvec_us']:.3f} and the rest (barrier, rhs "
                  f"exchange, reduction, update) {s['without_matvec_us']:.3f}"
                  f"; length 1 {s['step_length1_ms']:.4f} ms")
        print(f"[bench_segment_streamed] {shape}: twin "
              f"{rec['plain_ms']:.4f} ms")
        records.append(rec)
    result = dict(device=device_entry(dev), records=records, ok=ok)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(device=result["device"], ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
