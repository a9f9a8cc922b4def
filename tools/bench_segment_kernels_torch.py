#!/usr/bin/env python
"""Head-to-head of the batched ADMM-segment implementations on a CUDA card.

The PyTorch counterpart of tools/bench_segment_kernels.py: the segment
(x ← rhs·K⁻¹ plus clip/dual updates, ~40 iterations) at the flagship shape
(nU = 120 → P = 128, batch 512, 40 iterations), same seed-0 numpy inputs,
three candidates:

1. `torch-bmm`   — a stock-PyTorch loop of batched products (re-reads K⁻¹
   [B, 128, 128] from device memory every iteration); the reference the
   other two are held against.
2. `cuda-single` — the single-scenario kernel, one thread block per
   scenario with K⁻¹ resident in shared memory (ops/kernels.admm_segment).
3. `cuda-group8` — the grouped kernel, 8 scenarios per thread block
   (ops/kernels.admm_segment_grouped).

Usage: python tools/bench_segment_kernels_torch.py [batch=512] [iters=40]
Prints per-variant time and segments/s. Runs on ``cuda``; ``main`` takes
``device="cpu"`` for a dry run through the kernels' plain twins.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch


def make_inputs(B: int, nU: int = 120, P: int = 128, box0: int = 96):
    """The seed-0 numpy inputs of tools/bench_segment_kernels.py, padded to
    P: (Kinv, q, lb, ub, rho, rhoi, zero)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, nU, nU)).astype(np.float32)
    K = A @ A.transpose(0, 2, 1) / nU + 2.0 * np.eye(nU, dtype=np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    q = rng.standard_normal((B, nU)).astype(np.float32)
    lb = np.full((B, nU), -1e20, np.float32)
    ub = np.full((B, nU), 1e20, np.float32)
    lb[:, box0:], ub[:, box0:] = -1.0, 1.0
    rho = np.zeros((B, nU), np.float32)
    rho[:, box0:] = 0.5
    rhoi = np.where(rho > 0, 1.0 / np.maximum(rho, 1e-30), 0.0).astype(
        np.float32)
    zero = np.zeros((B, nU), np.float32)
    pad_v = lambda v: np.pad(v, ((0, 0), (0, P - nU)))  # noqa: E731
    Kp = np.pad(Kinv, ((0, 0), (0, P - nU), (0, P - nU)))
    return (Kp,) + tuple(pad_v(v) for v in (q, lb, ub, rho, rhoi, zero))


def torch_bmm_segment(Kinv, q, lb, ub, rho, rhoi, x, z, y, *, sigma, alpha,
                      length):
    """The stock-PyTorch segment: ``length`` iterations of batched products,
    K⁻¹ re-read from device memory every iteration."""
    for _ in range(length):
        rhs = sigma * x - q + rho * z - y
        x_t = torch.bmm(rhs[:, None, :], Kinv)[:, 0, :]
        x_n = alpha * x_t + (1 - alpha) * x
        z_rel = alpha * x_t + (1 - alpha) * z
        z_un = z_rel + y * rhoi
        z_n = torch.minimum(torch.maximum(z_un, lb), ub)
        y = rho * (z_un - z_n)
        x, z = x_n, z_n
    return x, z, y


def main(batch: int = 512, iters: int = 40, device=None, reps: int = 20):
    """Run the three variants; returns ``{"device", "ms": {name: ms},
    "err": {name: max |x − x_torch-bmm|}, "lines": [printed lines]}``."""
    from ironcub_mpc_tpu_torch import resolve_device
    from ironcub_mpc_tpu_torch.ops import kernels

    dev = resolve_device(device)
    B, LEN, nU = int(batch), int(iters), 120
    sigma, alpha_r = 1e-6, 1.6
    on_card = dev.type == "cuda"
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"

    Kp, qp_, lbp, ubp, rhop, rhoip, z0 = (
        torch.as_tensor(a, device=dev).contiguous() for a in make_inputs(B))

    kw = dict(sigma=sigma, alpha=alpha_r, length=LEN)

    def torch_bmm(*a):
        return torch_bmm_segment(*a, **kw)

    def cuda_single(*a):
        return kernels.admm_segment(*a, **kw)

    def cuda_group(*a):
        return kernels.admm_segment_grouped(*a, group=8, **kw)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    variants = [("torch-bmm", torch_bmm), ("cuda-single", cuda_single),
                ("cuda-group8", cuda_group)]
    args = (Kp, qp_, lbp, ubp, rhop, rhoip, z0, z0, z0)
    ms, errs, lines = {}, {}, []
    ref = None
    for name, fn in variants:
        out = fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        sync()
        dt = (time.perf_counter() - t0) / reps
        ms[name] = 1e3 * dt
        x = out[0][:, :nU].cpu().numpy()
        if ref is None:
            ref = x
        else:
            err = float(np.abs(x - ref).max())
            errs[name] = err
            assert err < 2e-3, (name, err)
        lines.append(f"{name:>14}: {1e3 * dt:7.3f} ms/segment-batch "
                     f"({B / dt:9.0f} segments/s)  device={where}")
        print(lines[-1])
    best = min(ms["cuda-single"], ms["cuda-group8"])
    lines.append(f"# cuda/torch ratio: {best / ms['torch-bmm']:.2f}x "
                 f"(>1 means the torch-bmm loop still wins throughput)")
    print(lines[-1])
    return {"device": where, "ms": ms, "err": errs, "lines": lines}


if __name__ == "__main__":
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(argv[0]) if argv else 512, int(argv[1]) if len(argv) > 1 else 40)
