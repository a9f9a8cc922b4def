"""The CUDA sources of the three kernels, run on the CPU.

A CUDA kernel has no interpret mode, so the card tests
(tests/test_torch_kernels_gpu.py) are the ones that hold the compiled
kernels against their twins. These tests hold the *logic* of the same
sources where there is no card: ``csrc/*.cu`` is compiled by ``g++`` against
the stand-in headers of tests/cuda_emu, loaded through the same C interface
as the real library and compared with the plain PyTorch twins. A launch of
the stand-in runs on the calling OS thread: a CUDA thread is a fiber, a
barrier a cooperative one that hands each fiber back to a scheduler, which
resumes them in thread order once the barrier has turned, a shuffle an
exchange through a per-warp array, a peer block's shared memory a pointer.
Covered: both variants of the segment, every route of the grouped segment,
every padded size and cluster size of the refresh's tuned routes and its
general route (its launches over output tiles and its elimination on a
cluster of 1, 2 or 8 blocks, at P = 256 with a box of 132, P = 384, P = 640,
M in shared and in device memory, ragged tile edges), every Gauss–Jordan
elimination, ragged boxes and the pivot clamp, and P = 1152, above the 1024
threads of a block (the general route with n_ns = 0; its Newton–Schulz
products at that size are left to the card). The segments' cluster route
runs on clusters of 1, 2, 4 and 8 blocks with K⁻¹'s strip in shared memory,
in registers and in shared memory only in part, their spread route at
P = 1152 and 4224 (a launch an iteration, NaN-filled scratch). A last test
holds that a launch makes no OS thread.
What the stand-in cannot see (timing, bank conflicts, a race between two
barriers, which its one fixed order never shows) stays with the card. Skips
where there is no ``g++``."""

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.ops import kernels

from test_torch_kernels_gpu import (ALPHA, BOX02, NU2, P, P2, SIGMA,
                                     _clamp_inputs, _segment_inputs,
                                     _wide_inputs, _woodbury_inputs)

EMU = Path(__file__).resolve().parent / "cuda_emu"
# the one declaration of the sources that has no meaning on the CPU: the
# dynamic shared memory of the block, which the stand-in hands out per block
DYNAMIC_SMEM = ("extern __shared__ float4 dyn_smem_f4[];",
                "float4* dyn_smem_f4 = emu::block_smem();")


def _numpy_blas_threads(n):
    """Sets the threads of numpy's bundled OpenBLAS (scipy-openblas) to
    ``n``; returns the count before, or None where numpy bundles none."""
    found = sorted((Path(np.__file__).parents[1] / "numpy.libs").glob(
        "libscipy_openblas*.so"))
    if not found:
        return None
    lib = ctypes.CDLL(str(found[0]))
    before = lib.scipy_openblas_get_num_threads64_()
    lib.scipy_openblas_set_num_threads64_(n)
    return before


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The inputs' numpy and the twins' PyTorch on one thread, as the
    launches are: beside five other pytest processes on eight cores, their
    threads (one a core each) took ~780 of the file's ~830 CPU seconds and
    tripled its wall time."""
    torch_before = torch.get_num_threads()
    torch.set_num_threads(1)
    blas_before = _numpy_blas_threads(1)
    yield
    torch.set_num_threads(torch_before)
    if blas_before is not None:
        _numpy_blas_threads(blas_before)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{name: ctypes library}`` of the three sources compiled for the
    CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    flags = ["-std=c++20", "-O1", "-Wno-unknown-pragmas"]
    decl, stand_in = DYNAMIC_SMEM
    # each source and header declares its dynamic shared memory in that one
    # form, if at all; the copies beside each other resolve their includes
    for path in sorted(kernels.CSRC.iterdir()):
        text = path.read_text()
        assert text.count("extern __shared__") == text.count(decl) <= 1, \
            path.name
        name = path.name.replace(".cu", ".cpp") if path.suffix == ".cu" \
            else path.name
        (out / name).write_text(text.replace(decl, stand_in))
    # the three builds at once, each writing its errors to a file of its own
    builds = {}
    for name, source in kernels.SOURCES.items():
        cpp = out / source.replace(".cu", ".cpp")
        with (out / f"{name}.log").open("w") as log:
            builds[name] = subprocess.Popen(
                [gxx, *flags, "-shared", "-fPIC", "-I", str(EMU), "-o",
                 str(out / f"{name}.so"), str(cpp)], stderr=log)
    libs = {}
    for name, build in builds.items():
        assert build.wait() == 0, (out / f"{name}.log").read_text()[-3000:]
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, argtypes in kernels.SEGMENT_ARGTYPES.items():
        getattr(libs[name], f"{name}_launch").argtypes = argtypes
    fn = libs["admm_segment"].admm_segment_cluster_smem_bytes
    fn.argtypes, fn.restype = [i, i, i], ctypes.c_long
    libs["woodbury_ns"].woodbury_ns_launch.argtypes = (
        [p] * 5 + [i, i, i, i, f, i, i, p])
    libs["woodbury_ns"].woodbury_ns_smem_bytes.argtypes = [i, i, i, i]
    kernels._bind_general(libs["woodbury_ns"])
    return libs


def _plan(ins, length, force):
    """segment_plan's launch for ``ins`` (``force`` its cluster or K⁻¹'s
    place), or, at a size the plan refuses (which the launcher must refuse
    too), the spread route's arguments."""
    B, p = ins[0].shape[0], ins[0].shape[-1]
    if p % 32:
        return dict(cluster=0, kinv_in_registers=False, spread_cols=32,
                    scratch_floats=0)
    return kernels.segment_plan(B, p, length, **force)


def _launch(lib, name, ins, length, *shape, **force):
    """The launcher of ``name`` on ``ins`` as the plan says, the spread
    route's scratch and the outputs NaN-filled, so that a read of an entry
    never written shows."""
    plan = _plan(ins, length, force)
    outs = [torch.full_like(ins[6], float("nan")) for _ in range(3)]
    n = plan["scratch_floats"]
    scratch = torch.full((n,), float("nan")) if n else None
    rc = getattr(lib, f"{name}_launch")(
        *(t.data_ptr() for t in ins + outs),
        None if scratch is None else scratch.data_ptr(), *shape, SIGMA, ALPHA,
        1.0 - ALPHA, length, plan["cluster"], int(plan["kinv_in_registers"]),
        plan["spread_cols"], None)
    return rc, outs


def _segment(lib, ins, length, **force):
    return _launch(lib, "admm_segment", ins, length, ins[0].shape[0],
                   ins[0].shape[-1], **force)


def _segment_sized(lib, ins, length, p, cluster=0, regs=0, cols=32,
                   scratch=None):
    """A launch that claims padded size ``p`` whatever the tensors hold,
    on the route ``cluster`` (0: spread, strips of ``cols``) says."""
    outs = [torch.zeros_like(ins[6]) for _ in range(3)]
    rc = lib.admm_segment_launch(
        *(t.data_ptr() for t in ins + outs),
        None if scratch is None else scratch.data_ptr(), 1, p, SIGMA, ALPHA,
        1.0 - ALPHA, length, cluster, regs, cols, None)
    return rc, outs


def _grouped(lib, ins, length, group, **force):
    return _launch(lib, "admm_segment_grouped", ins, length, ins[0].shape[0],
                   ins[0].shape[-1], group, **force)


def _general(lib, ins, box0, n_box, n_ns, **force):
    """The general route's launches as woodbury_plan chooses them (or with
    its tile edge, elimination cluster or the matrix's place forced)."""
    out = torch.full_like(ins[0], float("nan"))
    B, p = ins[0].shape[0], ins[0].shape[-1]
    plan = kernels.woodbury_general_plan(B, p, n_box, n_ns, **force)
    # NaN-filled: a read of scratch that was never written shows
    scratch = torch.full((plan["scratch_floats"],), float("nan"))
    rc = lib.woodbury_ns_general_launch(
        *(t.data_ptr() for t in ins + [out, scratch]), B, p, box0, n_box,
        SIGMA, n_ns, plan["tile"], plan["cluster"], int(plan["gj_in_smem"]),
        None)
    assert rc == 0
    return out


def _woodbury(lib, ins, box0, n_box, n_ns, cluster):
    out = torch.full_like(ins[0], float("nan"))
    rc = lib.woodbury_ns_launch(
        *(t.data_ptr() for t in ins + [out]), ins[0].shape[0],
        ins[0].shape[-1], box0, n_box, SIGMA, n_ns, cluster, None)
    assert rc == 0
    return out


# P = 1152 with a box of 8 and of 132: two coordinates a thread
P_BIG = 1152
BIG_BOXES = [(P_BIG - 12, P_BIG - 20), (P_BIG - 12, P_BIG - 144)]
# the segments' wide variant: five coordinates a thread, state in device
# memory; two scenarios, so that each reads and writes its own part of the
# scratch and the outputs
P_WIDE = 4224


@pytest.mark.parametrize("name", ["admm_segment", "admm_segment_grouped"])
def test_segment_sources_wide_variant_matches_twin(emulated, name):
    ins = [torch.as_tensor(v).contiguous() for v in
           _wide_inputs(18, 2, P_WIDE).values()]
    assert kernels.segment_plan(2, P_WIDE, 2)["route"] == "spread"
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=2)
    if name == "admm_segment":
        rc, got = _segment(emulated[name], ins, 2)
    else:
        rc, got = _grouped(emulated[name], ins, 2, 1)
    assert rc == 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("p,nu,box0", [(P, 120, 96), (P2, NU2, BOX02),
                                       (P_BIG, *BIG_BOXES[0]),
                                       (P_BIG, *BIG_BOXES[1])],
                         ids=["registers", "cluster", "spread-1152-box8",
                              "spread-1152-box132"])
def test_admm_segment_source_matches_twin(emulated, p, nu, box0):
    """Each route as the plan launches it at B = 2 (P = 1152 on 32-column
    strips, 36 blocks a scenario)."""
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(1, 2, nu=nu, box0=box0, p=p).values()]
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=5)
    rc, got = _segment(emulated["admm_segment"], ins, 5)
    assert rc == 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)


def test_admm_segment_source_keeps_nan_and_refuses_bad_shapes(emulated):
    lib = emulated["admm_segment"]
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(3, 2, nu=120, box0=96).values()]
    ins[6][1, 5] = float("nan")              # x of the second scenario
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=3)
    rc, got = _segment(lib, ins, 3)
    assert rc == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(g.numpy()),
                                      np.isnan(r.numpy()))
        np.testing.assert_allclose(g.numpy()[0], r.numpy()[0], rtol=0,
                                   atol=1e-5)
    # a padded size that is no multiple of 32 is refused, and a wide one
    # given no scratch (the launcher refuses before it reads anything, so
    # small tensors stand in); no size is refused for the shared memory
    # (P = 14,560 was, while the wide variant kept its state there)
    odd = [torch.zeros(1, 100, 100)] + [torch.zeros(1, 100)] * 8
    assert _segment(lib, odd, 1)[0] != 0
    rc, _ = _segment_sized(lib, odd, 1, P_WIDE)
    assert rc != 0


SEGMENTS = ["admm_segment", "admm_segment_grouped"]


def _route(lib, name, ins, length, **force):
    return (_segment(lib, ins, length, **force) if name == "admm_segment"
            else _grouped(lib, ins, length, ins[0].shape[0], **force))


def _hold(got, ref, atol=1e-5):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("name", SEGMENTS)
@pytest.mark.parametrize("cluster,regs", [(2, False), (4, False), (8, False),
                                          (2, True), (4, True), (8, True)])
def test_segment_cluster_route_matches_twin(emulated, name, cluster, regs):
    """P = 256 (the long horizon) on clusters of 2, 4 and 8 blocks, the
    strip in shared memory and in registers; two scenarios, so that each
    cluster reads and writes only its own."""
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(21, 2, nu=NU2, box0=BOX02, p=P2).values()]
    plan = kernels.segment_plan(2, P2, 3, cluster=cluster,
                                kinv_in_registers=regs)
    assert plan["route"] == "cluster"
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=3)
    rc, got = _route(emulated[name], name, ins, 3, cluster=cluster,
                     kinv_in_registers=regs)
    assert rc == 0
    _hold(got, ref)


@pytest.mark.parametrize("name", SEGMENTS)
@pytest.mark.parametrize("p,force", [(640, {}), (384, dict(cluster=4)),
                                     (384, dict(cluster=8))],
                         ids=["p640-cluster8", "p384-cluster4",
                              "p384-cluster8"])
def test_segment_cluster_route_at_other_sizes(emulated, name, p, force):
    """P = 640 as the plan launches it (the widest P a cluster of 8 holds
    whole, 80 columns a block) and P = 384 on clusters of 4 and 8, the
    strip in shared memory, two scenarios."""
    batch = 2
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(22, batch, nu=p - 16, box0=p - 150, p=p).values()]
    plan = kernels.segment_plan(batch, p, 2, **force)
    assert (plan["route"], plan["kinv_in_registers"]) == ("cluster", False)
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=2)
    rc, got = _route(emulated[name], name, ins, 2, **force)
    assert rc == 0
    _hold(got, ref)


@pytest.mark.parametrize("name", SEGMENTS)
@pytest.mark.parametrize("cols", kernels.SEGMENT_SPREAD_WIDTHS)
def test_segment_spread_route_matches_twin(emulated, name, cols):
    """P = 1152 spread over strips of 32, 16 and 8 columns (32 is the
    plan's at batch 2: 72 blocks, 16 at batch 1), one launch an iteration, two scenarios reading
    and writing their own halves of the NaN-filled scratch; 1152 is no
    multiple of the 64 and 128 rows a round of the narrower strips reads,
    so their last rounds are ragged."""
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(23, 2, nu=BIG_BOXES[1][0],
                           box0=BIG_BOXES[1][1], p=P_BIG).values()]
    assert kernels.segment_plan(2, P_BIG, 2)["spread_cols"] == 32
    assert kernels.segment_plan(1, P_BIG, 2)["spread_cols"] == 16
    plan = kernels.segment_plan(2, P_BIG, 2, spread_cols=cols)
    assert (plan["route"], plan["blocks"], plan["kernels"],
            plan["scratch_floats"]) == ("spread", 2 * P_BIG // cols, 2,
                                        2 * 2 * P_BIG)
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=2)
    rc, got = _route(emulated[name], name, ins, 2, spread_cols=cols)
    assert rc == 0
    _hold(got, ref)


@pytest.mark.parametrize("p,force", [(P2, {}), (P_BIG, {})],
                         ids=["cluster", "spread"])
def test_segment_routes_keep_nan_and_length_zero(emulated, p, force):
    """A NaN in one scenario's x stays in that scenario on both routes, the
    other matching the twin; a segment of length 0 returns the state."""
    lib = emulated["admm_segment"]
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(24, 2, nu=p - 16, box0=p - 64, p=p).values()]
    ins[6][1, 5] = float("nan")
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=2)
    rc, got = _segment(lib, ins, 2, **force)
    assert rc == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(g.numpy()),
                                      np.isnan(r.numpy()))
        assert np.isnan(g.numpy()[1, :p - 16]).all()
        np.testing.assert_allclose(g.numpy()[0], r.numpy()[0], rtol=0,
                                   atol=1e-5)
    rc, got = _segment(lib, ins, 0, **force)
    assert rc == 0
    for g, v in zip(got, ins[6:]):
        assert torch.equal(g.isnan(), v.isnan())
        assert torch.equal(g.nan_to_num(), v.nan_to_num())


def test_segment_routes_refuse_what_they_do_not_take(emulated):
    """The launcher refuses, before it reads anything (small tensors stand
    in): a cluster of 3 or 16, a strip that is no multiple of 8 columns
    (P = 288 on 8 blocks), more than 1024 threads (P = 640 on one block), a
    strip its block's shared memory does not hold whole (P = 256 on one
    block, 1152 on 8),
    K⁻¹ in registers at another P than 256 or on more than 512 threads, the
    spread route with K⁻¹ in registers, without its scratch or with strips
    of 4 or 64 columns; and the shared memory of every cluster block is the
    plan's."""
    odd = [torch.zeros(1, 32, 32)] + [torch.zeros(1, 32)] * 8
    scratch = torch.zeros(2 * P_BIG)
    lib = emulated["admm_segment"]
    for p, cluster, regs, cols, s in (
            (P2, 3, 0, 0, None), (P2, 16, 0, 0, None), (288, 8, 0, 0, None),
            (640, 1, 0, 0, None), (P2, 1, 0, 0, None), (P_BIG, 8, 0, 0, None),
            (640, 8, 1, 0, None), (P2, 1, 1, 0, None),
            (P_BIG, 0, 1, 32, scratch), (P_BIG, 0, 0, 32, None),
            (P_BIG, 0, 0, 4, scratch), (P_BIG, 0, 0, 64, scratch)):
        assert _segment_sized(lib, odd, 1, p, cluster, regs, cols,
                              s)[0] != 0, (p, cluster, regs, cols)
        assert not (cluster and kernels.segment_cluster_takes(p, cluster,
                                                               bool(regs)))
    for p in range(32, 2080, 32):
        for c in (1, 2, 3, 4, 8, 16):
            for regs in (False, True):
                want = (kernels.segment_cluster_smem_bytes(p, c, regs)
                        if kernels.segment_cluster_takes(p, c, regs) else -1)
                assert lib.admm_segment_cluster_smem_bytes(p, c, regs) == \
                    want, (p, c, regs)


@pytest.mark.parametrize("n_ns", [0, 2])
@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("nu,box0", [(120, 96), (120, 0), (117, 91),
                                     (100, 63)],
                         ids=["stock", "wide", "ragged-small",
                              "ragged-block"])
def test_woodbury_ns_source_matches_twin(emulated, nu, box0, cluster, n_ns):
    """One block and a cluster of 8; the small (n_box ≤ 32) and the
    block-wide elimination; boxes off a 16-byte boundary, sizes that are no
    multiple of 4."""
    _, _, ins = _woodbury_inputs(3, 1, nu, box0)
    ins = [torch.as_tensor(v).contiguous() for v in ins.values()]
    kw = dict(box0=box0, n_box=nu - box0, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
    got = _woodbury(emulated["woodbury_ns"], ins, cluster=cluster, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.numpy(), got.mT.numpy())


@pytest.mark.parametrize("n_ns", [0, 2])
@pytest.mark.parametrize("nu,box0", [(NU2, BOX02), (NU2, 120), (237, 181)],
                         ids=["stock-twice", "block", "ragged"])
def test_woodbury_ns_source_at_twice_the_stock_horizon(emulated, nu, box0,
                                                       n_ns):
    """P = 256 on a cluster of 8: the operand gathered a strip at a time."""
    _, _, ins = _woodbury_inputs(4, 1, nu, box0, p=P2)
    ins = [torch.as_tensor(v).contiguous() for v in ins.values()]
    kw = dict(box0=box0, n_box=nu - box0, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
    got = _woodbury(emulated["woodbury_ns"], ins, cluster=8, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.numpy(), got.mT.numpy())


@pytest.mark.parametrize("box0", [96, 0], ids=["small", "block"])
def test_woodbury_ns_source_pivot_clamp(emulated, box0):
    """A pivot of exactly 0 goes to +1e-12 and one of −2⁻⁴³ to −1e-12 in
    both eliminations, as in the twin."""
    ins = _clamp_inputs(box0)
    kw = dict(box0=box0, n_box=120 - box0, n_ns=0)
    ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
    assert ref[0, box0 + 3, box0 + 3] > 1e12
    assert ref[0, box0 + 8, box0 + 8] < -1e11
    got = _woodbury(emulated["woodbury_ns"], ins, cluster=1, **kw)
    assert torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().clamp_min(1.0)
    assert float(rel.max()) < 1e-5


def test_woodbury_source_refuses_what_it_is_not_built_for(emulated):
    """The tuned routes' launcher refuses what it is not built for; P = 384
    and a box of 240 at P = 256 agree with the twin on the general route,
    which refuses only an invalid box (it refused P above 1024 too: P = 1152
    now agrees with the twin)."""
    lib = emulated["woodbury_ns"]
    for p, n_box, cluster in ((P, 24, 2), (P2, 48, 1), (384, 24, 8),
                              (P2, 240, 8)):
        m, v = torch.zeros(1, p, p), torch.zeros(1, p)
        rc = lib.woodbury_ns_launch(
            *(t.data_ptr() for t in (m, m, v, v, torch.empty_like(m))), 1, p,
            0, n_box, SIGMA, 1, cluster, None)
        assert rc != 0, (p, n_box, cluster)
    for p, nu, box0 in ((384, 280, 256), (P2, NU2, 0), (P_BIG, P_BIG, 1128)):
        _, _, ins = _woodbury_inputs(13, 1, nu, box0, p=p)
        ins = [torch.as_tensor(v).contiguous() for v in ins.values()]
        kw = dict(box0=box0, n_box=nu - box0, n_ns=0)
        ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
        got = _general(lib, ins, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-6)
    # an invalid box, a tile edge or elimination cluster the launcher is not
    # built for, M in shared memory where no cluster's holds it
    for p, box0, n_box, tile, c, in_smem in (
            (P, 120, 24, 32, 1, 1), (P, 0, 0, 32, 1, 1),
            (P_BIG, 1140, 24, 64, 1, 1), (384, 0, 24, 16, 1, 1),
            (384, 0, 24, 128, 1, 1), (P_BIG, 0, 24, 64, 3, 1),
            (P_BIG, 0, 24, 64, 16, 1), (P_BIG, 0, 700, 64, 8, 1)):
        m, v = torch.zeros(1, p, p), torch.zeros(1, p)
        rc = lib.woodbury_ns_general_launch(
            *(t.data_ptr() for t in (m, m, v, v, torch.empty_like(m), m)), 1,
            p, box0, n_box, SIGMA, 1, tile, c, in_smem, None)
        assert rc != 0, (p, box0, n_box, tile, c, in_smem)


@pytest.mark.parametrize("p,nu,box0,n_ns,batch,force",
                         [(384, 288, 208, 1, 2, {}), (640, 528, 520, 0, 2, {}),
                          (384, 384, 84, 0, 2, dict(gj_in_smem=False)),
                          (P2, 132, 0, 2, 2, {}),
                          (P_BIG, *BIG_BOXES[0], 0, 1, {}),
                          (P_BIG, *BIG_BOXES[1], 0, 1, {}),
                          (384, 256, 123, 1, 1, {}),
                          (384, 256, 123, 0, 1, dict(tile=64, gj_cluster=2))],
                         ids=["p384-box80", "p640-box8", "gj-in-scratch",
                              "p256-box132", "p1152-box8", "p1152-box132",
                              "ragged-tiles", "ragged-cluster2"])
def test_woodbury_ns_general_source_matches_twin(emulated, p, nu, box0,
                                                 n_ns, batch, force):
    """The general route as the plan launches it: P = 384 and P = 640 at
    B = 2, the long horizon's box of 132 at P = 256 with two Newton–Schulz
    steps on a cluster of 8 at B = 2, P = 1152 (refused before) with a box
    of 8 (one block) and of 132 (a cluster of 8) at B = 1; the elimination
    in the device scratch (n_box 300, forced: the plan keeps M in a
    cluster's shared memory up to 672); ragged edges — n_box 133 against
    32- and 64-wide tiles and a cluster of 8 or 2 (17 or 67 rows a block),
    box0 = 123 off a 16-byte boundary, so that A's rows are copied 4 bytes
    at a time."""
    _, _, ins = _woodbury_inputs(14, batch, nu, box0, p=p)
    ins = [torch.as_tensor(v).contiguous() for v in ins.values()]
    kw = dict(box0=box0, n_box=nu - box0, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
    got = _general(emulated["woodbury_ns"], ins, **kw, **force)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.numpy(), got.mT.numpy())


def test_woodbury_ns_general_source_pivot_clamp(emulated):
    """A pivot of exactly 0 and one of −2⁻⁴³ in the general route's
    elimination, n_box 132 at P = 256."""
    ins = _clamp_inputs(0, nu=132, p=P2)
    kw = dict(box0=0, n_box=132, n_ns=0)
    ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
    assert ref[0, 3, 3] > 1e12 and ref[0, 8, 8] < -1e11
    got = _general(emulated["woodbury_ns"], ins, **kw)
    assert torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().clamp_min(1.0)
    assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("batch,p,nu,box0",
                         [(3, P, 120, 96), (5, P, 120, 96),
                          (2, P2, P2 - 16, P2 - 64), (2, 384, 368, 320),
                          (1, P_BIG, *BIG_BOXES[0]),
                          (1, P_BIG, *BIG_BOXES[1])],
                         ids=["registers", "registers-odd", "cluster",
                              "cluster-384", "spread-1152-box8",
                              "spread-1152-box132"])
def test_admm_segment_grouped_source_matches_twin(emulated, batch, p, nu,
                                                  box0):
    """Every route of the grouped segment, every group giving the same
    result (P = 1152 at B = 1 on 32-column strips, not the plan's 16:
    test_segment_spread_route_matches_twin runs every width)."""
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(15, batch, nu=nu, box0=box0, p=p).values()]
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=4)
    lib = emulated["admm_segment_grouped"]
    force = dict(spread_cols=32) if p == P_BIG else {}
    runs = [_grouped(lib, ins, 4, g, **force) for g in (1, batch)]
    for rc, got in runs:
        assert rc == 0
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=1e-5)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_admm_segment_grouped_source_keeps_nan_and_refuses_bad_shapes(
        emulated):
    lib = emulated["admm_segment_grouped"]
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(16, 4, nu=120, box0=96).values()]
    ins[6][3, 5] = float("nan")      # x of the last scenario
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=3)
    rc, got = _grouped(lib, ins, 3, 2)
    assert rc == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(g.numpy()),
                                      np.isnan(r.numpy()))
        np.testing.assert_allclose(g.numpy()[:3], r.numpy()[:3], rtol=0,
                                   atol=1e-5)
    # a group that does not divide B, a padded size that is no multiple of
    # 32 (P = 1056, refused before, is taken: the P = 1152 cases above)
    for batch, p, group in ((32, P, 5), (1, 100, 1)):
        bad = [torch.zeros(batch, p, p)] + [torch.zeros(batch, p)] * 8
        assert _grouped(lib, bad, 1, group)[0] != 0


def test_woodbury_layout_of_the_source_matches_the_plan(emulated):
    lib = emulated["woodbury_ns"]
    for tile in kernels.WOODBURY_GENERAL_TILES:
        assert lib.woodbury_ns_general_product_smem_bytes(tile) == \
            kernels.woodbury_general_product_smem_bytes(tile)
    for n_box in range(1, P_BIG + 1):
        for c in kernels.WOODBURY_GJ_CLUSTERS:
            for in_smem in (0, 1):
                assert lib.woodbury_ns_general_gj_smem_bytes(
                    n_box, c, in_smem) == \
                    kernels.woodbury_general_gj_smem_bytes(n_box, c, in_smem)
        for p in (n_box, P_BIG):
            for n_ns in (0, 1):
                assert lib.woodbury_ns_general_scratch_floats(
                    p, n_box, n_ns) == \
                    kernels.woodbury_general_scratch_floats(p, n_box, n_ns)
    fn = lib.woodbury_ns_smem_bytes
    for p, clusters in kernels.WOODBURY_CLUSTERS.items():
        for n_box in range(1, kernels.WOODBURY_MAX_BOX + 1):
            for n_ns in (0, 1):
                for c in clusters:
                    assert fn(p, n_box, n_ns, c) == \
                        kernels.woodbury_smem_bytes(n_box, n_ns, c, p), \
                        (p, n_box, n_ns, c)


def test_launch_makes_no_os_thread(emulated):
    """A launch runs its CUDA threads on the calling OS thread: while a
    segment runs on clusters of 8 blocks (1,024 CUDA threads a cluster at
    P = 256), a sampler counts the process's OS threads, and the count never
    passes the count before it plus the sampler (ctypes lets go of the GIL
    for the call, so the sampler runs beside the launch)."""
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(25, 2, nu=NU2, box0=BOX02, p=P2).values()]
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=3)
    before = len(os.listdir("/proc/self/task"))
    counts, sampling, stop = [], threading.Event(), threading.Event()

    def sample():
        while not stop.is_set():
            counts.append(len(os.listdir("/proc/self/task")))
            sampling.set()

    sampler = threading.Thread(target=sample)
    sampler.start()
    sampling.wait()
    try:
        rc, got = _segment(emulated["admm_segment"], ins, 3, cluster=8)
    finally:
        stop.set()
        sampler.join()
    assert rc == 0
    _hold(got, ref)
    assert max(counts) <= before + 1, (before, max(counts))
