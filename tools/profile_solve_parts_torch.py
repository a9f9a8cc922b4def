#!/usr/bin/env python
"""Time the condensed solve's parts of the PyTorch port one by one, and each
hand-written CUDA kernel beside its plain twin (counterpart of
tools/profile_solve_parts.py).

Usage: python tools/profile_solve_parts_torch.py [batch=512] [--iters 20]
           [--device cuda]

At the hover state of ``examples/realtime_driver_torch.hover_setup`` with
``batch`` lanes whose momentum carries a seeded jitter, on the host clock
over ``--iters`` calls between two synchronisations, as the JAX tool:

  condense (sequential), condense (assoc)
  factor(chol+inv)           Cholesky and the explicit inverse of K(ρ)
  cholesky only
  scan 60 iters              60 ADMM iterations in plain PyTorch
  one woodbury(2xNS)         a ρ×3 Woodbury refresh with 2 Newton–Schulz
  2x newton-schulz
  24x24 lin solve            the capacitance solve alone
  condense nIter=128 (sequential), (assoc)   a long synthetic horizon

then each kernel of ``ops/kernels.py`` on the same K⁻¹ and QP, timed on
CUDA events beside its twin, with the largest difference between the two
and the launches the wrapper counted in the calls the timing made (its
sizing call and the timed ones):

  admm_segment (60 iters)            the segment, K⁻¹ resident
  admm_segment_grouped (60 iters)    the same, a group of scenarios a block
  woodbury_ns (refresh, 1 NS)        one refresh: ρ → 3ρ on the box
  woodbury_ns (polish, 0 NS)         the polish operator: ρ → active/δ

On the CPU a wrapper runs its twin, so both columns time the twin. Runs on
``cuda`` unless ``--device`` says otherwise; ends with one JSON line of
the times, the kernels' rows and ``"device"``, the card's name and power
limit.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

from common_torch import (batched_hover, device_entry, event_ms,  # noqa: E402
                          host_ms, option, positional)

VALUED = ("iters", "device")
SCAN_ITERS = 60
LONG = dict(n_iter=128, n_iter_small=64, control_horizon=65)


def kernel_rows(K, H, Kinv, q, lb, ub, settings, batch, iters, dev):
    """Each kernel against its twin on the lifted layout of one condensed
    QP batch: CUDA-event ms of both, the largest difference relative to the
    twin's largest entry, the launches counted in the kernel's calls."""
    import torch
    import torch.nn.functional as F_

    B, nU = H.shape[0], H.shape[-1]
    nb = lb.shape[-1]
    box0 = nU - nb
    P = K._pad_to(nU)
    s = settings

    def lift(A):
        return F_.pad(A, (0, P - nU, 0, P - nU)).contiguous()

    def box(v, fill=0.0):
        out = torch.full((B, P), fill, dtype=H.dtype, device=dev)
        out[:, box0:nU] = v
        return out

    rho = torch.full((B, nb), s.rho, dtype=H.dtype, device=dev)
    lb_f, ub_f = box(lb, -s.inf_bound), box(ub, s.inf_bound)
    lb_f[:, nU:] = 0.0
    ub_f[:, nU:] = 0.0
    x0 = torch.zeros((B, P), dtype=H.dtype, device=dev)
    seg = (lift(Kinv), F_.pad(q, (0, P - nU)).contiguous(), lb_f, ub_f,
           box(rho), box(1.0 / rho), x0, torch.clamp(x0, lb_f, ub_f),
           x0.clone())
    seg_kw = dict(sigma=s.sigma, alpha=s.alpha, length=SCAN_ITERS)
    group = math.gcd(B, 8)
    # the polish operator's ρ: active/δ on every other box coordinate
    active = torch.zeros_like(rho)
    active[:, ::2] = 1.0
    polish_rho = active / s.delta_polish
    cases = [
        ("admm_segment (60 iters)", K.admm_segment, K.admm_segment_plain,
         seg, seg_kw),
        (f"admm_segment_grouped (60 iters, group {group})",
         K.admm_segment_grouped, K.admm_segment_grouped_plain, seg,
         dict(seg_kw, group=group)),
        ("woodbury_ns (refresh, 1 NS)", K.woodbury_ns, K.woodbury_ns_plain,
         (lift(Kinv), lift(H), box(2.0 * rho), box(3.0 * rho)),
         dict(box0=box0, n_box=nb, sigma=s.sigma, n_ns=1)),
        ("woodbury_ns (polish, 0 NS)", K.woodbury_ns, K.woodbury_ns_plain,
         (lift(Kinv), lift(H), box(polish_rho - rho), box(polish_rho)),
         dict(box0=box0, n_box=nb, sigma=s.sigma, n_ns=0)),
    ]
    rows = []
    for name, kern, plain, args, kw in cases:
        name_k = kern.__name__
        got, want = kern(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((g - w).abs().max() / w.abs().max().clamp_min(1.0))
                  for g, w in zip(got, want))
        calls = [0]

        def timed(kern=kern, args=args, kw=kw):
            calls[0] += 1
            return kern(*args, **kw)

        before = getattr(K, name_k).launches
        ms = event_ms(timed, dev, iters, warmup=0)
        launches = getattr(K, name_k).launches - before
        plain_ms = event_ms(lambda: plain(*args, **kw), dev,
                            max(1, iters // 4), warmup=0)
        rows.append(dict(name=name, kernel=name_k, batch=B, P=P, ms=ms,
                         plain_ms=plain_ms, rel_err=err, calls=calls[0],
                         launches=launches))
        print(f"{name:40s} {ms:8.4f} ms  twin {plain_ms:8.4f} ms  "
              f"rel err {err:.2e}  launches {launches} in {calls[0]} calls",
              flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, VALUED)
    batch = int(pos[0]) if pos else 512
    iters = int(option(argv, "iters", 20))

    import torch

    from ironcub_mpc_tpu_torch.core.config import MPCConfig
    from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.ops import kernels as K
    from ironcub_mpc_tpu_torch.qp import condensed
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc
    from ironcub_mpc_tpu_torch.qp.blocks import LinearizedDynamics

    settings = admm.ADMMSettings(max_iter=60, polish=True,
                                 rho_update_iters=(15, 40))
    cfg, sched, sel, settings, problem, carries, snaps, est = batched_hover(
        batch, settings, device=option(argv, "device"))
    dev = carries.warm_x.device
    carries2, preps = vs_mpc._tick_prep(cfg, sel, problem, carries, snaps,
                                        est)
    print(f"# solve parts, batch={batch}, {iters} calls each, "
          f"device={device_entry(dev)}", flush=True)
    ms = {}

    def bench(name, fn, n=batch):
        out = fn()
        ms[name] = host_ms(fn, dev, iters, warmup=0)
        print(f"{name:32s} {ms[name]:8.3f} ms  "
              f"({n / ms[name] * 1e3:10.0f} /s)", flush=True)
        return out

    for mode in ("sequential", "assoc"):
        mcfg = dataclasses.replace(cfg, condense_mode=mode)
        qps = bench(f"condense ({mode})", lambda m=mcfg: (
            vs_mpc.condense_from_prep(m, sched, sel, problem, carries2,
                                      preps)[0]))

    nU = qps.H.shape[-1]
    nb = qps.lb.shape[-1]
    box0 = nU - nb
    s = settings
    rho_box = torch.full((batch, nb), s.rho, dtype=qps.H.dtype, device=dev)
    eye = torch.eye(nU, dtype=qps.H.dtype, device=dev)

    def k_matrix(rho):
        return condensed._k_matrix(qps.H, s.sigma, box0, rho)

    Kinv = bench("factor(chol+inv)",
                 lambda: condensed._inverse_by_cholesky(k_matrix(rho_box)))
    bench("cholesky only", lambda: torch.linalg.cholesky_ex(
        k_matrix(rho_box))[0])

    def scan60():
        x = torch.zeros((batch, nU), dtype=qps.H.dtype, device=dev)
        z = torch.clamp(x[:, box0:], qps.lb, qps.ub)
        y = torch.zeros_like(z)
        rho = s.rho
        for _ in range(SCAN_ITERS):
            rhs = s.sigma * x - qps.q
            rhs = torch.cat([rhs[:, :box0], rhs[:, box0:] + rho * z - y], -1)
            x_t = (Kinv @ rhs[..., None])[..., 0]
            x_n = s.alpha * x_t + (1 - s.alpha) * x
            z_rel = s.alpha * x_t[:, box0:] + (1 - s.alpha) * z
            z_un = z_rel + y / rho
            z_n = torch.clamp(z_un, qps.lb, qps.ub)
            y = rho * (z_un - z_n)
            x, z = x_n, z_n
        return x, z, y

    bench(f"scan {SCAN_ITERS} iters", scan60)

    def newton_schulz(Knew, K_, n):
        for _ in range(n):
            Knew = Knew @ (2.0 * eye - K_ @ Knew)
        return Knew

    def one_woodbury():
        d = 2.0 * rho_box
        M = (torch.eye(nb, dtype=qps.H.dtype, device=dev)
             + d[:, :, None] * Kinv[:, box0:, box0:])
        X = torch.linalg.solve(M, d[:, :, None] * Kinv[:, box0:, :])
        Knew = Kinv - Kinv[:, :, box0:] @ X
        Knew = newton_schulz(Knew, k_matrix(3.0 * rho_box), 2)
        return 0.5 * (Knew + Knew.mT)

    bench("one woodbury(2xNS)", one_woodbury)
    bench("2x newton-schulz", lambda: newton_schulz(
        Kinv, k_matrix(rho_box), 2))

    def small_solve():
        d = torch.full((batch, nb), 2.0, dtype=qps.H.dtype, device=dev)
        M = (torch.eye(nb, dtype=qps.H.dtype, device=dev)
             + d[:, :, None] * Kinv[:, box0:, box0:])
        return torch.linalg.solve(M, d[:, :, None] * Kinv[:, box0:, :])

    bench(f"{nb}x{nb} lin solve", small_solve)

    # the horizon-parallel chain at a long horizon (synthetic linearisation
    # of the same block structure; both modes on identical inputs)
    long_batch = min(batch, 16)
    cfg128 = dataclasses.replace(MPCConfig(), **LONG)
    sched128 = build_schedule(cfg128)
    H_u128 = torch.as_tensor(condensed.build_hu(cfg128), dtype=torch.float32,
                             device=dev)
    rng = np.random.default_rng(0)
    ns, nj, nt = cfg128.n_states, cfg128.n_ctrl_joints, cfg128.n_jets

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    lins = LinearizedDynamics(
        Ac=f32(0.05 * rng.standard_normal((long_batch, ns, ns))),
        BJ=f32(rng.standard_normal((long_batch, ns, nj))),
        BT=f32(rng.standard_normal((long_batch, ns, nt))),
        c=f32(rng.standard_normal((long_batch, ns))))
    x0s = f32(rng.standard_normal((long_batch, ns)))
    refs = f32(rng.standard_normal((long_batch, ns, cfg128.n_iter)))
    zeros = dict(dtype=torch.float32, device=dev)
    for mode in ("sequential", "assoc"):
        mcfg = dataclasses.replace(cfg128, condense_mode=mode)
        bench(f"condense nIter=128 ({mode})", lambda m=mcfg: condensed.condense(
            m, sched128, lins, x0s, refs, torch.ones(ns, **zeros), H_u128,
            torch.zeros((long_batch, nj), **zeros),
            torch.zeros((long_batch, nt), **zeros),
            torch.zeros(long_batch, dtype=torch.bool, device=dev),
            torch.full((long_batch, 4), 60.0, **zeros)), n=long_batch)

    print(f"# the CUDA kernels beside their twins, batch={batch} "
          f"({'CUDA events' if dev.type == 'cuda' else 'twins only: CPU'})",
          flush=True)
    rows = kernel_rows(K, qps.H, Kinv, qps.q, qps.lb, qps.ub, s, batch,
                       iters, dev)
    record = {"tool": "profile_solve_parts", "batch": batch, "iters": iters,
              "ms": ms, "kernels": rows, "device": device_entry(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
