"""The condensed solve's hot primitives: hand-written CUDA kernels for
Hopper, their plain PyTorch twins and their launch counters.

Counterpart of ``ironcub_mpc_tpu/ops/pallas_solve.py``:

- :func:`admm_segment` replaces ``pallas_solve.admm_segment`` — ``length``
  over-relaxed ADMM iterations with K⁻¹ resident on chip, in registers at
  P = 128 (``csrc/admm_segment.cu``; :func:`segment_plan` picks the variant).
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
  or on a cluster of 8, or, for the shapes those do not take, on one block
  with a device scratch (``csrc/woodbury_ns.cu``; :func:`woodbury_plan`
  picks the route and the cluster size).

All take the full, lane-padded layout of the Pallas kernels with a leading
batch dimension B: matrices [B, P, P], vectors [B, P] (P = 128 for the
stock nU = 120; every padded size up to 1024, on the card too). Box entries sit at ``box0:``; outside the box ρ = 0, 1/ρ =
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
        if name == "admm_segment":
            fn.argtypes = [p] * 12 + [i, i, f, f, f, i, p]
        elif name == "admm_segment_grouped":
            fn.argtypes = [p] * 12 + [i, i, i, f, f, f, i, p]
        else:
            fn.argtypes = [p] * 5 + [i, i, i, i, f, i, i, p]
            lib.woodbury_ns_smem_bytes.restype = i
            lib.woodbury_ns_smem_bytes.argtypes = [i, i, i, i]
            lib.woodbury_ns_general_launch.restype = i
            lib.woodbury_ns_general_launch.argtypes = (
                [p] * 6 + [i, i, i, i, f, i, p])
            lib.woodbury_ns_general_smem_bytes.restype = i
            lib.woodbury_ns_general_smem_bytes.argtypes = [i]
            lib.woodbury_ns_general_scratch_floats.restype = ctypes.c_long
            lib.woodbury_ns_general_scratch_floats.argtypes = [i, i]
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


SEGMENT_REG_THREADS = 512


def segment_plan(B: int, P: int) -> dict:
    """The launch :func:`admm_segment` makes at padded size ``P``: the
    variant, the blocks, the threads of a block and its shared memory.

    One rule, by size alone, which the source's launcher applies: K⁻¹ in
    registers at P = 128 (the stock layout), else re-read through L2 every
    iteration."""
    if P % 32 or not 0 < P <= MAX_THREADS:
        raise ValueError(f"admm_segment: padded size {P} must be a multiple "
                         f"of 32 in (0, {MAX_THREADS}]")
    if P == LANE:
        return dict(variant="registers", blocks=B,
                    threads=SEGMENT_REG_THREADS, smem_bytes=4 * 2 * LANE)
    return dict(variant="streamed", blocks=B, threads=P, smem_bytes=4 * P)


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
    segment_plan(B, P)
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


def grouped_plan(B: int, P: int, group: int) -> dict:
    """The launch :func:`admm_segment_grouped` makes: :func:`segment_plan`'s
    rule and shapes (the source's launcher picks its variant by P as
    csrc/admm_segment.cu's does), after checking that ``group`` divides B.

    ``group`` is not used: the placement follows the card. At P = 128 each
    scenario's K⁻¹ stays in the registers of one block of 512 threads for
    the whole segment, two blocks an SM, in the grouped kernel's own layout;
    any other padded size (a multiple of 32 up to 1024) streams K⁻¹ through
    L2, one thread a coordinate."""
    _check_group(B, group)
    return segment_plan(B, P)


def admm_segment_grouped(Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b,
                         y_b, *, sigma: float, alpha: float, length: int,
                         group: int = 8):
    """Batched ADMM segment, ``group`` scenarios per program on the TPU.

    ``Kinv_b`` is [B, P, P], every vector [B, P] in the full layout, B
    divisible by ``group``. Returns the updated ``(x, z, y)``, each [B, P].
    ``group`` keeps only its contract: B must be divisible by it, and every
    group gives the same result. On the card the placement is
    :func:`grouped_plan`'s, chosen by P (any padded size that is a multiple
    of 32 up to 1024)."""
    B, P = Kinv_b.shape[0], Kinv_b.shape[-1]
    _check_group(B, group)
    if not _dispatch("admm_segment_grouped", Kinv_b):
        return admm_segment_grouped_plain(
            Kinv_b, q_b, lb_b, ub_b, rho_b, rhoi_b, x_b, z_b, y_b,
            sigma=sigma, alpha=alpha, length=length, group=group)
    grouped_plan(B, P, group)
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


WOODBURY_THREADS = 256
# padded size -> the cluster sizes (blocks a scenario is spread over) the
# tuned routes are built for; at P = 256 only a cluster's shared memory
# holds X and T
WOODBURY_CLUSTERS = {128: (1, 8), 256: (8,)}
# the widest box the tuned routes' elimination takes
WOODBURY_MAX_BOX = LANE
# floats beside the matrices: pivot rows and columns [2][2][128] and d [128]
WOODBURY_VEC_FLOATS = 5 * LANE
# the largest padded size of the general route (segment_plan's cap)
WOODBURY_MAX_P = 1024
# the general route's product tiles in shared memory: A [32, 65], B [32, 64]
WOODBURY_GENERAL_TILE_FLOATS = 32 * 65 + 32 * 64


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


def _general_gj_in_smem(n_box: int) -> bool:
    vec = 2 * (-(-n_box // 4) * 4)
    return 4 * (WOODBURY_GENERAL_TILE_FLOATS + vec + n_box * n_box) <= MAX_SMEM


def woodbury_general_smem_bytes(n_box: int) -> int:
    """Dynamic shared memory of one block of the general route
    (``general_smem_floats`` of csrc/woodbury_ns.cu): the product tiles,
    the pivot row and column (n_box rounded up to 4 each) and, while it
    fits (n_box ≤ 231), the Gauss–Jordan matrix [n_box, n_box]."""
    vec = 2 * (-(-n_box // 4) * 4)
    gj = n_box * n_box if _general_gj_in_smem(n_box) else 0
    return 4 * (WOODBURY_GENERAL_TILE_FLOATS + vec + gj)


def woodbury_general_scratch_floats(P: int, n_box: int) -> int:
    """Device scratch of one scenario of the general route
    (``general_scratch_floats``): X, W or K, and 2I − KX [3, P, P], and the
    Gauss–Jordan matrix where shared memory does not hold it."""
    return 3 * P * P + (0 if _general_gj_in_smem(n_box) else n_box * n_box)


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

    Every other padded size that is a multiple of 128 up to 1024, and every
    wider box, takes the ``general`` route: one block a scenario, its
    intermediates in a device scratch."""
    if P % LANE or not 0 < P <= WOODBURY_MAX_P:
        raise ValueError(f"woodbury_ns: padded size {P} must be a multiple "
                         f"of {LANE} up to {WOODBURY_MAX_P}")
    if P not in WOODBURY_CLUSTERS or n_box > WOODBURY_MAX_BOX:
        if cluster is not None:
            raise ValueError(f"woodbury_ns: cluster size {cluster} forced at "
                             f"padded size {P}, n_box {n_box}: the general "
                             "route runs one block a scenario")
        return dict(route="general", cluster=1, blocks=B,
                    threads=WOODBURY_THREADS,
                    smem_bytes=woodbury_general_smem_bytes(n_box),
                    scratch_floats=B * woodbury_general_scratch_floats(
                        P, n_box))
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


def woodbury_ns(Kinv_p, H_p, d_f, rho_f, *, box0: int, n_box: int,
                sigma: float, n_ns: int, cluster: int | None = None):
    """(K(ρ_new))⁻¹ from (K(ρ_old))⁻¹ per lane.

    ``Kinv_p`` and ``H_p`` are [B, P, P]; ``d_f`` = ρ_new − ρ_old and
    ``rho_f`` = ρ_new are [B, P] in the full layout (zero outside the box
    entries [box0, box0 + n_box)). Returns the symmetrised [B, P, P]. On the
    card P is a multiple of 128 up to 1024 with any box (``woodbury_plan``
    picks the route); a larger P raises. ``cluster`` overrides the cluster
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
            # allocated on this stream, so no launch in flight shares it
            scratch = torch.empty(plan["scratch_floats"],
                                  dtype=torch.float32, device=Kinv_p.device)
            rc = lib.woodbury_ns_general_launch(
                *ptrs, scratch.data_ptr(), B, P, int(box0), int(n_box),
                float(sigma), int(n_ns), stream)
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
