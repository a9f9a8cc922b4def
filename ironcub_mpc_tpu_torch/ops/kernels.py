"""The condensed solve's hot primitives: hand-written CUDA kernels for
Hopper, their plain PyTorch twins and their launch counters.

Counterpart of ``ironcub_mpc_tpu/ops/pallas_solve.py``:

- :func:`admm_segment` replaces ``pallas_solve.admm_segment`` — ``length``
  over-relaxed ADMM iterations with K⁻¹ resident on chip, in registers at
  P = 128, in the column strips of a cluster of blocks up to P = 640, and
  beyond spread over the card in a launch an iteration
  (``csrc/admm_segment.cu`` and ``.cuh``; :func:`segment_plan` picks the
  route).
- :func:`admm_segment_grouped` replaces ``pallas_solve.admm_segment_grouped``
  — the same segment over a batch, every K⁻¹ in the registers of one block
  at P = 128 in a layout whose column sums take fewer shuffles than
  :func:`admm_segment`'s (``csrc/admm_segment_grouped.cu``;
  :func:`grouped_plan` picks the route);
  the batched head-to-head of ``tools/bench_segment_kernels_torch.py`` runs
  it, the tick does not.
- :func:`woodbury_ns` replaces ``pallas_solve.woodbury_ns`` — the rank-n_box
  Woodbury ρ-refresh of K⁻¹ with its Gauss–Jordan capacitance inverse,
  Newton–Schulz steps and symmetrised output, a scenario on one thread block
  or on a cluster of 8, or, for the shapes those do not take, in 4 + 2·n_ns
  launches with a device scratch: the products over (scenario, output
  tile), the elimination on a cluster (``csrc/woodbury_ns.cu``;
  :func:`woodbury_plan` picks the route and the cluster size,
  :func:`woodbury_general_plan` the general route's launches).

All take the full, lane-padded layout of the Pallas kernels with a leading
batch dimension B: matrices [B, P, P], vectors [B, P] (P = 128 for the
stock nU = 120; on the card the segments take any multiple of 32 and the
refresh any multiple of 128, device memory their only cap). Box entries sit at ``box0:``;
outside the box ρ = 0, 1/ρ = 0 and the bounds are ±inf_bound, so no masks
are needed.

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
# the most dynamic shared memory one block may use on Hopper (227 KB) and
# the most threads of one block
MAX_SMEM = 232448
MAX_THREADS = 1024
MAX_CLUSTER = 8
NUM_SMS = 132
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
    # the headers a source may include count towards its tag
    src = b"".join(path.read_bytes() for path in
                   [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
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
        if name in SEGMENT_ARGTYPES:
            fn.argtypes = SEGMENT_ARGTYPES[name]
        else:
            fn.argtypes = [p] * 5 + [i, i, i, i, f, i, i, p]
            lib.woodbury_ns_smem_bytes.restype = i
            lib.woodbury_ns_smem_bytes.argtypes = [i, i, i, i]
            _bind_general(lib)
        _libs[name] = lib
    return lib


# the segment launchers' C interfaces: 13 pointers, (B, P[, group]), σ, α,
# 1 − α, length, cluster, K⁻¹ in registers, spread columns, the stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SEGMENT_ARGTYPES = {
    "admm_segment": [_P] * 13 + [_I, _I, _F, _F, _F] + [_I] * 4 + [_P],
    "admm_segment_grouped": [_P] * 13 + [_I] * 3 + [_F] * 3 + [_I] * 4
    + [_P]}


def _bind_general(lib):
    """The general route's C interface of ``woodbury_ns.cu`` (built here
    with nvcc, or for the CPU by tests/test_torch_kernels_emulated.py)."""
    p, i, f, long_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_long
    lib.woodbury_ns_general_launch.restype = i
    lib.woodbury_ns_general_launch.argtypes = (
        [p] * 6 + [i, i, i, i, f, i, i, i, i, p])
    lib.woodbury_ns_general_product_smem_bytes.restype = i
    lib.woodbury_ns_general_product_smem_bytes.argtypes = [i]
    lib.woodbury_ns_general_gj_smem_bytes.restype = long_
    lib.woodbury_ns_general_gj_smem_bytes.argtypes = [i, i, i]
    lib.woodbury_ns_general_scratch_floats.restype = long_
    lib.woodbury_ns_general_scratch_floats.argtypes = [i, i, i]


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


SEGMENT_REG_THREADS = 512
# the cluster and spread routes (csrc/admm_segment.cuh, kept in step by
# tests/test_torch_kernels.py): a warp of a cluster block owns 8 columns of
# its strip, whose rows are padded by 4 floats in shared memory; K⁻¹'s strip
# goes into registers only at P = 256, on at most 512 threads a block; a
# spread block of 256 threads owns 32, 16 or 8 columns
SEGMENT_COLS, SEGMENT_PAD = 8, 4
SEGMENT_CLUSTERS = (1, 2, 4, 8)
SEGMENT_REG_P, SEGMENT_REG_MAX_THREADS = 256, 512
SEGMENT_SPREAD_WIDTHS, SEGMENT_SPREAD_THREADS = (32, 16, 8), 256


def segment_cluster_smem_bytes(P: int, C: int, regs: bool = False) -> int:
    """Dynamic shared memory of a cluster block (``seg_cluster_smem_bytes``):
    rhs [2, P] and, but where K⁻¹ lies in registers, the strip
    [P, P/C + 4]."""
    return 4 * (2 * P + (0 if regs else P * (P // C + SEGMENT_PAD)))


def segment_cluster_takes(P: int, C: int, regs: bool = False) -> bool:
    """Whether the cluster route runs P on clusters of C
    (``seg_cluster_takes``): the strip a multiple of 8 columns, at most 1024
    threads (512 with K⁻¹ in registers, only at P = 256), the whole strip on
    chip."""
    if C not in SEGMENT_CLUSTERS or P % C or (P // C) % SEGMENT_COLS:
        return False
    threads = 32 * (P // C) // SEGMENT_COLS
    if threads > (SEGMENT_REG_MAX_THREADS if regs else MAX_THREADS):
        return False
    if regs and P != SEGMENT_REG_P:
        return False
    return segment_cluster_smem_bytes(P, C, regs) <= MAX_SMEM


def segment_plan(B: int, P: int, length: int = 1, *, cluster=None,
                 kinv_in_registers=None, spread_cols=None) -> dict:
    """The launch :func:`admm_segment` makes at padded size ``P`` for a
    segment of ``length`` iterations: the route, the cluster (blocks a
    scenario), where K⁻¹ lies, the spread route's strip width, the blocks,
    the threads of a block, its shared memory, the device scratch in floats
    and the kernels a call.

    Three routes. K⁻¹ in registers at P = 128 (the stock layout). Else a
    scenario on a cluster of C blocks, each holding a column strip of K⁻¹
    for the whole segment, where some cluster holds all of it (P up to
    640): C is the largest such cluster where B·C blocks still have an SM
    each (a lone scenario on 8 SMs), else the smallest (2 at P = 256: a
    batch is then a block of 512 threads a scenario and SM); at P = 256
    the strip lies in registers. Beyond, the "spread" route: a strip of 32
    columns a block over the card — 16 or 8 where B·P / 32 blocks would
    leave over half the SMs idle — one kernel an iteration, rhs in a device
    scratch of 2·B·P floats. Device memory is the only cap. ``cluster`` (1,
    2, 4 or 8; 0 for the spread route), ``kinv_in_registers`` and
    ``spread_cols`` force a choice the launcher takes
    (tools/bench_segment_streamed_torch.py times each)."""
    if P % 32 or P <= 0:
        raise ValueError(f"admm_segment: padded size {P} must be a positive "
                         f"multiple of 32")
    if P == LANE:
        return dict(route="registers", cluster=1, kinv_in_registers=True,
                    spread_cols=0, blocks=B, threads=SEGMENT_REG_THREADS,
                    smem_bytes=4 * 2 * LANE, scratch_floats=0, kernels=1)
    if cluster is None:
        whole = [c for c in SEGMENT_CLUSTERS if segment_cluster_takes(P, c)]
        cluster = 0
        if whole:
            cluster = max(whole) if B * max(whole) <= NUM_SMS else min(whole)
    if cluster == 0:
        if kinv_in_registers:
            raise ValueError("admm_segment: the spread route keeps no K⁻¹ "
                             "in registers")
        if spread_cols is None:
            spread_cols = next((w for w in SEGMENT_SPREAD_WIDTHS
                                if 2 * B * (P // w) >= NUM_SMS),
                               SEGMENT_SPREAD_WIDTHS[-1])
        if spread_cols not in SEGMENT_SPREAD_WIDTHS:
            raise ValueError(f"admm_segment: the spread route does not take "
                             f"strips of {spread_cols} columns")
        return dict(route="spread", cluster=0, kinv_in_registers=False,
                    spread_cols=spread_cols,
                    blocks=B * (P // spread_cols),
                    threads=SEGMENT_SPREAD_THREADS,
                    smem_bytes=4 * 8 * spread_cols,
                    scratch_floats=2 * B * P, kernels=max(1, int(length)))
    if spread_cols is not None:
        raise ValueError("admm_segment: spread_cols forced on the cluster "
                         "route")
    if kinv_in_registers is None:
        kinv_in_registers = segment_cluster_takes(P, cluster, True)
    regs = bool(kinv_in_registers)
    if not segment_cluster_takes(P, cluster, regs):
        raise ValueError(f"admm_segment: the cluster route does not take "
                         f"P = {P} on clusters of {cluster}"
                         f"{' with K⁻¹ in registers' if regs else ''}")
    return dict(route="cluster", cluster=cluster, kinv_in_registers=regs,
                spread_cols=0, blocks=B * cluster,
                threads=32 * (P // cluster) // SEGMENT_COLS,
                smem_bytes=segment_cluster_smem_bytes(P, cluster, regs),
                scratch_floats=0, kernels=1)


def _segment_launch(name: str, ins, plan: dict, *, sigma: float,
                    alpha: float, length: int, group: int = 1):
    """One call of a segment kernel's launches as ``plan`` says, on CUDA
    tensors ``ins`` (K⁻¹ and the eight vectors), with the spread route's
    scratch allocated on the current stream. Returns ``(x, z, y)``."""
    x_f = ins[6]
    B, P = ins[0].shape[0], ins[0].shape[-1]
    xo, zo, yo = (torch.empty_like(x_f) for _ in range(3))
    n = plan["scratch_floats"]
    scratch = torch.empty(n, dtype=x_f.dtype, device=x_f.device) if n \
        else None
    fn = getattr(_lib(name), f"{name}_launch")
    shape = (B, P, int(group)) if name == "admm_segment_grouped" else (B, P)
    with torch.cuda.device(x_f.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (*ins, xo, zo, yo)),
                None if scratch is None else scratch.data_ptr(), *shape,
                float(sigma), float(alpha), float(1.0 - alpha), int(length),
                plan["cluster"], int(plan["kinv_in_registers"]),
                plan["spread_cols"], stream)
    _raise_on(rc, name)
    return xo, zo, yo


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
    plan = segment_plan(B, P, length)
    vecs = dict(q_f=q_f, lb_f=lb_f, ub_f=ub_f, rho_f=rho_f, rhoi_f=rhoi_f,
                x_f=x_f, z_f=z_f, y_f=y_f)
    _check_segment(Kinv_p, vecs)
    out = _segment_launch("admm_segment", (Kinv_p, *vecs.values()), plan,
                          sigma=sigma, alpha=alpha, length=length)
    admm_segment.launches += 1
    return out


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


def grouped_plan(B: int, P: int, group: int, length: int = 1) -> dict:
    """The launch :func:`admm_segment_grouped` makes: :func:`segment_plan`'s
    rule and shapes (the grouped source runs the same cluster and spread
    kernels), after checking that ``group`` divides B.

    ``group`` is not used: the placement follows the card. At P = 128 each
    scenario's K⁻¹ stays in the registers of one block of 512 threads for
    the whole segment, two blocks an SM, in the grouped kernel's own layout;
    any other padded size (a multiple of 32) takes the cluster or the
    spread route as :func:`segment_plan` says."""
    _check_group(B, group)
    return segment_plan(B, P, length)


def admm_segment_grouped(Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b,
                         y_b, *, sigma: float, alpha: float, length: int,
                         group: int = 8):
    """Batched ADMM segment, ``group`` scenarios per program on the TPU.

    ``Kinv_b`` is [B, P, P], every vector [B, P] in the full layout, B
    divisible by ``group``. Returns the updated ``(x, z, y)``, each [B, P].
    ``group`` keeps only its contract: B must be divisible by it, and every
    group gives the same result. On the card the placement is
    :func:`grouped_plan`'s, chosen by P and B (any padded size that is a
    multiple of 32)."""
    B, P = Kinv_b.shape[0], Kinv_b.shape[-1]
    _check_group(B, group)
    if not _dispatch("admm_segment_grouped", Kinv_b):
        return admm_segment_grouped_plain(
            Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b, y_b,
            sigma=sigma, alpha=alpha, length=length, group=group)
    plan = grouped_plan(B, P, group, length)
    vecs = dict(q_b=q_b, lb_b=lb_b, ub_b=ub_b, rho_b=rho_b, rhoi_b=rhoi_b,
                x_b=x_b, z_b=z_b, y_b=y_b)
    _check_segment(Kinv_b, vecs)
    out = _segment_launch("admm_segment_grouped", (Kinv_b, *vecs.values()),
                          plan, sigma=sigma, alpha=alpha, length=length,
                          group=group)
    admm_segment_grouped.launches += 1
    return out


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


WOODBURY_THREADS = 256
# padded size -> the cluster sizes (blocks a scenario is spread over) the
# tuned routes are built for; at P = 256 only a cluster's shared memory
# holds X and T
WOODBURY_CLUSTERS = {128: (1, 8), 256: (8,)}
# the widest box the tuned routes' elimination takes
WOODBURY_MAX_BOX = LANE
# floats beside the matrices: pivot rows and columns [2][2][128] and d [128]
WOODBURY_VEC_FLOATS = 5 * LANE


def woodbury_smem_bytes(n_box: int, n_ns: int = 1, cluster: int = 1,
                        P: int = LANE) -> int:
    """Dynamic shared memory of one block of the tuned routes when a
    scenario is spread over ``cluster`` blocks (``make_layout`` of
    csrc/woodbury_ns.cu, kept in step by tests/test_torch_kernels.py): the
    strip of X [R, P], G [n8, P] (later the strip of T [R, P]), U [R, n4],
    the strip of K [R, P] (in U's place when both do not fit), the pivot
    and d vectors and, for a cluster, the gathered operand ([P, P] at
    P = 128, [R, P] beyond); R = P / cluster, n8 and n4 are n_box rounded up
    to 8 and 4; T and K only for n_ns > 0."""
    R = P // cluster
    n8, n4 = -(-n_box // 8) * 8, -(-n_box // 4) * 4
    gt = (max(R, n8) if n_ns > 0 else n8) * P
    u = R * n4
    h = R * P if n_ns > 0 else 0
    gathered = 0 if cluster == 1 else (P if P == LANE else R) * P
    rest = R * P + gt + WOODBURY_VEC_FLOATS + gathered
    if 4 * (rest + u + h) <= MAX_SMEM:
        return 4 * (rest + u + h)
    return 4 * (rest + max(u, h))


# the general route (csrc/woodbury_ns.cu, kept in step by
# tests/test_torch_kernels.py): product blocks of 8 × 16 threads over T × T
# output tiles, T one of WOODBURY_GENERAL_TILES, staged 32 deep with rows of
# A padded by 4 floats; elimination blocks of 256 threads on a cluster of
# 1, 2, 4 or 8; the symmetrisation on 32 × 32 tiles by 32 × 8 threads
WOODBURY_GENERAL_THREADS = 128
WOODBURY_GENERAL_TILES = (32, 64)
WOODBURY_GENERAL_DEPTH, WOODBURY_GENERAL_PAD = 32, 4
WOODBURY_GJ_THREADS = 256
WOODBURY_GJ_CLUSTERS = (1, 2, 4, 8)
WOODBURY_SYM_TILE, WOODBURY_SYM_ROWS = 32, 8
# the elimination of a box wider than this is spread over a cluster
WOODBURY_GJ_SPREAD = 32


def woodbury_general_product_smem_bytes(tile: int) -> int:
    """Dynamic shared memory of one product block of the general route
    (``gen_stage_floats`` of csrc/woodbury_ns.cu): two stages of an A tile
    [tile, 32 + 4] and a B tile [32, tile]."""
    d = WOODBURY_GENERAL_DEPTH
    return 4 * 2 * (tile * (d + WOODBURY_GENERAL_PAD) + d * tile)


def woodbury_general_gj_smem_bytes(n_box: int, cluster: int,
                                   in_smem: bool = True) -> int:
    """Dynamic shared memory of one elimination block of a cluster of
    ``cluster`` (``gj_smem_floats``): the scaled pivot row, double-buffered
    [2, n32], the strip's pivot column [2, R4] and, ``in_smem``, the strip
    of M [R, n32]; R = ⌈n_box / cluster⌉ rows a block, n32 = n_box rounded
    up to 32, R4 to 4."""
    R = -(-n_box // cluster)
    n32 = -(-n_box // 32) * 32
    return 4 * (2 * n32 + 2 * (-(-R // 4) * 4) + (R * n32 if in_smem else 0))


def woodbury_general_scratch_floats(P: int, n_box: int, n_ns: int) -> int:
    """Device scratch of one scenario of the general route
    (``general_scratch_floats``): G [n_box, n32], its rows padded to a
    multiple of 32, then W [n_box, P] for n_ns = 0, or two [P, P] buffers
    (W and 2I − K·X, and the X that is not in the output)."""
    return n_box * -(-n_box // 32) * 32 + (2 * P * P if n_ns else n_box * P)


def woodbury_general_plan(B: int, P: int, n_box: int, n_ns: int,
                          tile: int | None = None,
                          gj_cluster: int | None = None,
                          gj_in_smem: bool | None = None) -> dict:
    """The launches of the general route, 4 + 2·n_ns kernels a call: the
    elimination G = M⁻¹ on a cluster, the products W, X and, per
    Newton–Schulz step, 2I − K·X and X·(2I − K·X) as launches over
    (scenario, output tile), and the symmetrisation over pairs of mirror
    tiles. Returns ``woodbury_plan``'s keys (``cluster`` the elimination's,
    ``blocks`` the widest grid, ``threads`` a product block's,
    ``smem_bytes`` the most any block takes) with ``tile``, ``gj_in_smem``,
    ``kernels`` and ``stages`` (name, blocks, threads, cluster, shared
    memory of each launch).

    The choices, each of which the arguments can force: the tile edge is 64
    where B · (P / 64)² tiles fill the card's SMs, else 32 (four times the
    blocks); M lives in the cluster's shared memory where a cluster of 8
    holds it, else in the scratch (on a cluster of 8); a box wider than
    WOODBURY_GJ_SPREAD is eliminated on the largest cluster whose B · C
    blocks are at most two an SM (8 for a lone scenario, 4 at B = 64),
    never on fewer blocks than hold M; a narrower one on the fewest that
    hold it (tools/bench_woodbury_general_torch.py times every choice)."""
    n = n_box
    fits = [c for c in WOODBURY_GJ_CLUSTERS
            if woodbury_general_gj_smem_bytes(n, c) <= MAX_SMEM]
    if tile is None:
        tile = 64 if B * (P // 64) ** 2 >= NUM_SMS else 32
    if gj_in_smem is None:
        gj_in_smem = bool(fits)
    if gj_cluster is None:
        if not gj_in_smem:
            gj_cluster = MAX_CLUSTER
        elif n > WOODBURY_GJ_SPREAD:
            wide = [c for c in WOODBURY_GJ_CLUSTERS if B * c <= 2 * NUM_SMS]
            gj_cluster = max(wide + fits[:1])
        else:
            gj_cluster = fits[0]
    gj_smem = woodbury_general_gj_smem_bytes(n, gj_cluster, gj_in_smem)
    if tile not in WOODBURY_GENERAL_TILES or P % tile:
        raise ValueError(f"woodbury_ns: tile edge {tile} is not one of "
                         f"{WOODBURY_GENERAL_TILES} dividing {P}")
    if gj_cluster not in WOODBURY_GJ_CLUSTERS or gj_smem > MAX_SMEM:
        raise ValueError(f"woodbury_ns: an elimination cluster of "
                         f"{gj_cluster} cannot hold n_box {n} in shared "
                         "memory")
    prod = dict(threads=WOODBURY_GENERAL_THREADS, cluster=1,
                smem_bytes=woodbury_general_product_smem_bytes(tile))
    square = B * (P // tile) ** 2
    sym = P // WOODBURY_SYM_TILE
    stages = [dict(name="gauss_jordan", blocks=B * gj_cluster,
                   threads=WOODBURY_GJ_THREADS, cluster=gj_cluster,
                   smem_bytes=gj_smem),
              dict(prod, name="W", blocks=B * -(-n // tile) * (P // tile)),
              dict(prod, name="X", blocks=square)]
    for _ in range(int(n_ns)):
        stages += [dict(prod, name="2I-KX", blocks=square),
                   dict(prod, name="X(2I-KX)", blocks=square)]
    stages.append(dict(name="symmetrise", blocks=B * sym * (sym + 1) // 2,
                       threads=WOODBURY_SYM_TILE * WOODBURY_SYM_ROWS,
                       cluster=1,
                       smem_bytes=4 * 2 * WOODBURY_SYM_TILE
                       * (WOODBURY_SYM_TILE + 1)))
    return dict(route="general", cluster=gj_cluster,
                blocks=max(s["blocks"] for s in stages),
                threads=WOODBURY_GENERAL_THREADS,
                smem_bytes=max(s["smem_bytes"] for s in stages),
                scratch_floats=B * woodbury_general_scratch_floats(P, n,
                                                                   n_ns),
                tile=tile, gj_in_smem=gj_in_smem, kernels=len(stages),
                stages=stages)


def woodbury_plan(B: int, P: int, n_box: int, n_ns: int,
                  cluster: int | None = None) -> dict:
    """The launch :func:`woodbury_ns` makes: the route, the cluster size
    (blocks a scenario is spread over), the blocks, the threads of a block,
    its shared memory and the device scratch (floats).

    The tuned routes take P = 128 and P = 256 with n_box ≤ 128, everything
    in shared memory and registers. At P = 128 a scenario fits one block; it
    is spread over 8 only where there is a product worth splitting (a
    Newton–Schulz step, or a box wider than the 32 a single pass inverts)
    and every block of the batch still has an SM of its own (B · 8 ≤ 132),
    so a lone scenario draws on 8 SMs; a batch that fills the card loses
    time to gathering the peers' strips (PERF.md has both timed on an H100).
    At P = 256 the matrices fit only a cluster of 8. ``cluster`` forces a
    size the tuned routes are built for (the card tests time both).

    Every other padded size that is a multiple of 128, and every wider box,
    takes the ``general`` route (:func:`woodbury_general_plan`): the
    products spread over the card, the elimination on a cluster, the
    intermediates in a device scratch. No padded size is refused for its
    size: device memory caps it (the scratch is 8·P² bytes a scenario with
    Newton–Schulz steps, beside the 12·P² of K⁻¹, H and the result)."""
    if P % LANE or P <= 0:
        raise ValueError(f"woodbury_ns: padded size {P} must be a positive "
                         f"multiple of {LANE}")
    if P not in WOODBURY_CLUSTERS or n_box > WOODBURY_MAX_BOX:
        if cluster is not None:
            raise ValueError(f"woodbury_ns: cluster size {cluster} forced at "
                             f"padded size {P}, n_box {n_box}: the general "
                             "route chooses its own")
        return woodbury_general_plan(B, P, n_box, n_ns)
    sizes = WOODBURY_CLUSTERS[P]
    if cluster is None:
        split = n_ns > 0 or n_box > 32
        lone = split and B * MAX_CLUSTER <= NUM_SMS
        cluster = MAX_CLUSTER if lone or 1 not in sizes else 1
    if cluster not in sizes:
        raise ValueError(f"woodbury_ns: cluster size {cluster} is not one of "
                         f"{sizes} at padded size {P}")
    smem = woodbury_smem_bytes(n_box, n_ns, cluster, P)
    if smem > MAX_SMEM:
        raise ValueError(f"woodbury_ns: n_box={n_box} needs more shared "
                         "memory than one block has")
    return dict(route="tuned", cluster=cluster, blocks=B * cluster,
                threads=WOODBURY_THREADS, smem_bytes=smem, scratch_floats=0)


def _general_launch(lib, ptrs, plan, B, P, box0, n_box, sigma, n_ns, device,
                    stream) -> int:
    """The general route's launches for ``ptrs`` (K⁻¹, H, d, ρ, out) as
    ``plan`` says, with a scratch allocated on ``stream``, so that no launch
    in flight shares it. Returns the launcher's CUDA error code."""
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=device)
    return lib.woodbury_ns_general_launch(
        *ptrs, scratch.data_ptr(), B, P, int(box0), int(n_box), float(sigma),
        int(n_ns), plan["tile"], plan["cluster"], int(plan["gj_in_smem"]),
        stream)


def woodbury_ns(Kinv_p, H_p, d_f, rho_f, *, box0: int, n_box: int,
                sigma: float, n_ns: int, cluster: int | None = None):
    """(K(ρ_new))⁻¹ from (K(ρ_old))⁻¹ per lane.

    ``Kinv_p`` and ``H_p`` are [B, P, P]; ``d_f`` = ρ_new − ρ_old and
    ``rho_f`` = ρ_new are [B, P] in the full layout (zero outside the box
    entries [box0, box0 + n_box)). Returns the symmetrised [B, P, P]. On the
    card P is any multiple of 128 with any box (``woodbury_plan`` picks the
    route). ``cluster`` overrides the cluster
    size the plan would choose where a tuned route runs (card only)."""
    P = Kinv_p.shape[-1]
    if box0 < 0 or n_box < 1 or box0 + n_box > P:
        raise ValueError(
            f"box [{box0}, {box0 + n_box}) invalid for padded size {P} "
            f"(need box0 >= 0, n_box >= 1, box0 + n_box <= P)")
    if not _dispatch("woodbury_ns", Kinv_p):
        return woodbury_ns_plain(Kinv_p, H_p, d_f, rho_f, box0=box0,
                                 n_box=n_box, sigma=sigma, n_ns=n_ns)
    B = Kinv_p.shape[0]
    plan = woodbury_plan(B, P, n_box, int(n_ns), cluster)
    _check(dict(Kinv_p=Kinv_p, H_p=H_p, d_f=d_f, rho_f=rho_f), Kinv_p.device,
           dict(Kinv_p=(B, P, P), H_p=(B, P, P), d_f=(B, P), rho_f=(B, P)))
    out = torch.empty_like(Kinv_p)
    lib = _lib("woodbury_ns")
    with torch.cuda.device(Kinv_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (Kinv_p, H_p, d_f, rho_f, out)]
        if plan["route"] == "general":
            rc = _general_launch(lib, ptrs, plan, B, P, box0, n_box, sigma,
                                 n_ns, Kinv_p.device, stream)
        else:
            rc = lib.woodbury_ns_launch(
                *ptrs, B, P, int(box0), int(n_box), float(sigma), int(n_ns),
                plan["cluster"], stream)
    _raise_on(rc, "woodbury_ns")
    woodbury_ns.launches += 1
    return out


woodbury_ns.launches = 0


def reset_launches():
    admm_segment.launches = 0
    admm_segment_grouped.launches = 0
    woodbury_ns.launches = 0
