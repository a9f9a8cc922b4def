"""The condensed solve's hot primitives: hand-written CUDA kernels for
Hopper, their plain PyTorch twins and their launch counters.

Counterpart of ``ironcub_mpc_tpu/ops/pallas_solve.py``:

- :func:`admm_segment` replaces ``pallas_solve.admm_segment`` — ``length``
  over-relaxed ADMM iterations with K⁻¹ resident on chip
  (``csrc/admm_segment.cu``).
- :func:`admm_segment_grouped` replaces ``pallas_solve.admm_segment_grouped``
  — the same segment with ``group`` scenarios advanced by one program
  (``csrc/admm_segment_grouped.cu``); the batched head-to-head of
  ``tools/bench_segment_kernels_torch.py`` runs it, the tick does not.
- :func:`woodbury_ns` replaces ``pallas_solve.woodbury_ns`` — the rank-n_box
  Woodbury ρ-refresh of K⁻¹ with its Gauss–Jordan capacitance inverse,
  Newton–Schulz steps and symmetrised output (``csrc/woodbury_ns.cu``).

All take the full, lane-padded layout of the Pallas kernels with a leading
batch dimension B: matrices [B, P, P], vectors [B, P] (P = 128 for the
stock nU = 120). Box entries sit at ``box0:``; outside the box ρ = 0, 1/ρ =
0 and the bounds are ±inf_bound, so no masks are needed.

A wrapper runs its plain twin only because its tensors lie on the CPU. For
CUDA tensors it launches its kernel or raises; it never falls back. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernels are compiled by ``nvcc`` at first use into ``build/torch_kernels/``
at the repository root (one shared library with a plain C interface per
source, loaded with ``ctypes``). :func:`build` compiles all of them at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LANE = 128
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"admm_segment": "admm_segment.cu",
           "admm_segment_grouped": "admm_segment_grouped.cu",
           "woodbury_ns": "woodbury_ns.cu"}
# the most dynamic shared memory one block may use on Hopper (227 KB), the
# most threads of one block and its named barriers besides __syncthreads
MAX_SMEM = 232448
MAX_THREADS = 1024
MAX_NAMED_BARRIERS = 15
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def _pad_to(n: int) -> int:
    return ((n + LANE - 1) // LANE) * LANE


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: ptxas report}`` for the
    sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def _lib(name: str):
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "admm_segment":
            fn.argtypes = [p] * 12 + [i, i, f, f, f, i, p]
        elif name == "admm_segment_grouped":
            fn.argtypes = [p] * 12 + [i, i, i, f, f, f, i, p]
        else:
            fn.argtypes = [p] * 6 + [i, i, i, i, f, i, p]
        _libs[name] = lib
    return lib


def _check(tensors: dict, device, shapes: dict):
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{key} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{key} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")


def _check_segment(Kinv_p, vecs: dict):
    """The checks shared by the two segment wrappers: K⁻¹ [B, P, P] and
    every vector [B, P]."""
    B, P = Kinv_p.shape[0], Kinv_p.shape[-1]
    shapes = {k: (B, P) for k in vecs}
    shapes["Kinv_p"] = (B, P, P)
    _check(dict(Kinv_p=Kinv_p, **vecs), Kinv_p.device, shapes)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _dispatch(name: str, t: torch.Tensor) -> bool:
    """True for the kernel, False for the plain twin; raises on any other
    device type."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


# --------------------------------------------------------------------------
# 1. ADMM segment
# --------------------------------------------------------------------------

def admm_segment_plain(Kinv_p, q_f, lb_f, ub_f, rho_f, rhoi_f, x_f, z_f, y_f,
                       *, sigma: float, alpha: float, length: int):
    """Plain PyTorch twin of :func:`admm_segment` (the row-vector form
    x̃ = rhs·K⁻¹ of the Pallas kernel)."""
    x, z, y = x_f, z_f, y_f
    for _ in range(int(length)):
        rhs = sigma * x - q_f + rho_f * z - y
        x_t = (rhs[:, None, :] @ Kinv_p)[:, 0, :]
        x_n = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * x_t + (1.0 - alpha) * z
        z_un = z_rel + y * rhoi_f
        z_n = torch.minimum(torch.maximum(z_un, lb_f), ub_f)
        y = rho_f * (z_un - z_n)
        x, z = x_n, z_n
    return x, z, y


def admm_segment(Kinv_p, q_f, lb_f, ub_f, rho_f, rhoi_f, x_f, z_f, y_f,
                 *, sigma: float, alpha: float, length: int):
    """Run ``length`` ADMM iterations per lane with K⁻¹ resident on chip.

    ``Kinv_p`` is [B, P, P], every vector [B, P] in the full layout.
    Returns the updated ``(x, z, y)``, each [B, P]."""
    if not _dispatch("admm_segment", Kinv_p):
        return admm_segment_plain(Kinv_p, q_f, lb_f, ub_f, rho_f, rhoi_f,
                                  x_f, z_f, y_f, sigma=sigma, alpha=alpha,
                                  length=length)
    B, P = Kinv_p.shape[0], Kinv_p.shape[-1]
    if P % 32 or not 0 < P <= 1024:
        raise ValueError(f"admm_segment: padded size {P} must be a multiple "
                         "of 32 in (0, 1024]")
    vecs = dict(q_f=q_f, lb_f=lb_f, ub_f=ub_f, rho_f=rho_f, rhoi_f=rhoi_f,
                x_f=x_f, z_f=z_f, y_f=y_f)
    _check_segment(Kinv_p, vecs)
    xo, zo, yo = (torch.empty_like(x_f) for _ in range(3))
    fn = _lib("admm_segment").admm_segment_launch
    with torch.cuda.device(Kinv_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (Kinv_p, q_f, lb_f, ub_f, rho_f,
                                         rhoi_f, x_f, z_f, y_f, xo, zo, yo)),
                B, P, float(sigma), float(alpha), float(1.0 - alpha),
                int(length), stream)
    _raise_on(rc, "admm_segment")
    admm_segment.launches += 1
    return xo, zo, yo


admm_segment.launches = 0


# --------------------------------------------------------------------------
# 1b. ADMM segment, `group` scenarios per program
# --------------------------------------------------------------------------

def _check_group(B: int, group: int):
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if B % group:
        raise ValueError(f"batch {B} not divisible by group {group}")


def admm_segment_grouped_plain(Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b,
                               z_b, y_b, *, sigma: float, alpha: float,
                               length: int, group: int = 8):
    """Plain PyTorch twin of :func:`admm_segment_grouped`: the batch cut into
    [B/G, G, ...] groups, each group's G row-vector products x̃ = rhs·K⁻¹
    taken together."""
    B, P = Kinv_b.shape[0], Kinv_b.shape[-1]
    _check_group(B, group)
    n_g = B // group
    Kg = Kinv_b.reshape(n_g, group, P, P)
    q, lb, ub, rho, rhoi, x, z, y = (
        v.reshape(n_g, group, P)
        for v in (q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b, y_b))
    for _ in range(int(length)):
        rhs = sigma * x - q + rho * z - y
        x_t = (rhs[:, :, None, :] @ Kg)[:, :, 0, :]
        x_n = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * x_t + (1.0 - alpha) * z
        z_un = z_rel + y * rhoi
        z_n = torch.minimum(torch.maximum(z_un, lb), ub)
        y = rho * (z_un - z_n)
        x, z = x_n, z_n
    return x.reshape(B, P), z.reshape(B, P), y.reshape(B, P)


def admm_segment_grouped(Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b,
                         y_b, *, sigma: float, alpha: float, length: int,
                         group: int = 8):
    """Batched ADMM segment, ``group`` scenarios per program.

    ``Kinv_b`` is [B, P, P], every vector [B, P] in the full layout, B
    divisible by ``group``. Returns the updated ``(x, z, y)``, each [B, P].
    On the card one thread block advances its ``group`` scenarios, so
    ``group · P`` must fit a block's 1024 threads and ``group`` its 15 named
    barriers (group ≤ 8 at P = 128); a larger group raises."""
    B, P = Kinv_b.shape[0], Kinv_b.shape[-1]
    _check_group(B, group)
    if not _dispatch("admm_segment_grouped", Kinv_b):
        return admm_segment_grouped_plain(
            Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b, y_b,
            sigma=sigma, alpha=alpha, length=length, group=group)
    if P % 32 or P < 32:
        raise ValueError(f"admm_segment_grouped: padded size {P} must be a "
                         "positive multiple of 32")
    if group * P > MAX_THREADS or group > MAX_NAMED_BARRIERS:
        raise ValueError(
            f"admm_segment_grouped: group {group} x padded size {P} does not "
            f"fit one thread block ({MAX_THREADS} threads, "
            f"{MAX_NAMED_BARRIERS} scenario barriers)")
    vecs = dict(q_b=q_b, lb_b=lb_b, ub_b=ub_b, rho_b=rho_b, rhoi_b=rhoi_b,
                x_b=x_b, z_b=z_b, y_b=y_b)
    _check_segment(Kinv_b, vecs)
    xo, zo, yo = (torch.empty_like(x_b) for _ in range(3))
    fn = _lib("admm_segment_grouped").admm_segment_grouped_launch
    with torch.cuda.device(Kinv_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (Kinv_b, q_b, lb_b, ub_b, rho_b,
                                         rhoi_b, x_b, z_b, y_b, xo, zo, yo)),
                B, P, int(group), float(sigma), float(alpha),
                float(1.0 - alpha), int(length), stream)
    _raise_on(rc, "admm_segment_grouped")
    admm_segment_grouped.launches += 1
    return xo, zo, yo


admm_segment_grouped.launches = 0


# --------------------------------------------------------------------------
# 2. Woodbury ρ-refresh + Newton–Schulz
# --------------------------------------------------------------------------

def gj_inverse(M):
    """Batched explicit inverse of [B, n, n] by Gauss–Jordan on [M | I],
    no pivoting; a pivot with |piv| < 1e-12 is clamped to ∓1e-12 (+1e-12
    for 0)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand_as(M)
    A = torch.cat([M, eye], dim=-1)
    for i in range(n):
        piv = A[:, i, i]
        piv = torch.where(piv.abs() < 1e-12,
                          torch.where(piv < 0, -1e-12, 1e-12).to(piv.dtype),
                          piv)
        row = A[:, i] / piv[:, None]
        A = A - A[:, :, i:i + 1] * row[:, None, :]
        A[:, i] = row
    return A[:, :, n:]


def woodbury_ns_plain(Kinv_p, H_p, d_f, rho_f, *, box0: int, n_box: int,
                      sigma: float, n_ns: int):
    """Plain PyTorch twin of :func:`woodbury_ns`, in the rank-n_box form the
    CUDA kernel computes."""
    P = Kinv_p.shape[-1]
    bx = slice(box0, box0 + n_box)
    d = d_f[:, bx]
    eye_b = torch.eye(n_box, dtype=Kinv_p.dtype, device=Kinv_p.device)
    M = eye_b + d[:, :, None] * Kinv_p[:, bx, bx]
    W = gj_inverse(M) @ (d[:, :, None] * Kinv_p[:, bx, :])
    X = Kinv_p - Kinv_p[:, :, bx] @ W
    if n_ns:
        eye = torch.eye(P, dtype=Kinv_p.dtype, device=Kinv_p.device)
        K = H_p + sigma * eye + torch.diag_embed(rho_f)
        for _ in range(int(n_ns)):
            X = X @ (2.0 * eye - K @ X)
    return 0.5 * (X + X.mT)


def woodbury_smem_bytes(n_box: int) -> int:
    """Dynamic shared memory of the woodbury_ns kernel: the [n_box, 2·n_box]
    Gauss–Jordan buffer, its pivot row and column, and two matmul tiles
    (kept in step with csrc/woodbury_ns.cu)."""
    return 4 * (2 * n_box * n_box + 3 * n_box + 32 * 65 + 32 * 64)


def woodbury_ns(Kinv_p, H_p, d_f, rho_f, *, box0: int, n_box: int,
                sigma: float, n_ns: int):
    """(K(ρ_new))⁻¹ from (K(ρ_old))⁻¹ per lane.

    ``Kinv_p`` and ``H_p`` are [B, P, P]; ``d_f`` = ρ_new − ρ_old and
    ``rho_f`` = ρ_new are [B, P] in the full layout (zero outside the box
    entries [box0, box0 + n_box)). Returns the symmetrised [B, P, P]."""
    P = Kinv_p.shape[-1]
    if box0 < 0 or n_box < 1 or box0 + n_box > P:
        raise ValueError(
            f"box [{box0}, {box0 + n_box}) invalid for padded size {P} "
            f"(need box0 >= 0, n_box >= 1, box0 + n_box <= P)")
    if not _dispatch("woodbury_ns", Kinv_p):
        return woodbury_ns_plain(Kinv_p, H_p, d_f, rho_f, box0=box0,
                                 n_box=n_box, sigma=sigma, n_ns=n_ns)
    B = Kinv_p.shape[0]
    if P % 64:
        raise ValueError(f"woodbury_ns: padded size {P} must be a multiple "
                         "of 64")
    if woodbury_smem_bytes(n_box) > MAX_SMEM:
        raise ValueError(f"woodbury_ns: n_box={n_box} needs more shared "
                         "memory than one block has")
    _check(dict(Kinv_p=Kinv_p, H_p=H_p, d_f=d_f, rho_f=rho_f), Kinv_p.device,
           dict(Kinv_p=(B, P, P), H_p=(B, P, P), d_f=(B, P), rho_f=(B, P)))
    out = torch.empty_like(Kinv_p)
    scratch = torch.empty((B, 3, P, P), dtype=Kinv_p.dtype,
                          device=Kinv_p.device)
    fn = _lib("woodbury_ns").woodbury_ns_launch
    with torch.cuda.device(Kinv_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (Kinv_p, H_p, d_f, rho_f, out,
                                         scratch)),
                B, P, int(box0), int(n_box), float(sigma), int(n_ns), stream)
    _raise_on(rc, "woodbury_ns")
    woodbury_ns.launches += 1
    return out


woodbury_ns.launches = 0


def reset_launches():
    admm_segment.launches = 0
    admm_segment_grouped.launches = 0
    woodbury_ns.launches = 0
