"""The CUDA sources of the three kernels, run on the CPU.

A CUDA kernel has no interpret mode, so the card tests
(tests/test_torch_kernels_gpu.py) are the ones that hold the compiled
kernels against their twins. These tests hold the *logic* of the same
sources where there is no card: ``csrc/*.cu`` is compiled by ``g++`` against
the stand-in headers of tests/cuda_emu (a CUDA thread is an OS thread, a
barrier a ``std::barrier``, a shuffle an exchange through a per-warp array,
a peer block's shared memory a pointer), loaded through the same C interface
as the real library and compared with the plain PyTorch twins: both variants
of the segment, every route of the grouped segment, every padded size and
cluster size of the refresh's tuned routes and its general route (P = 256
with a box of 132, P = 384, P = 640, the elimination in shared and in device
memory), every Gauss–Jordan elimination, ragged boxes and the pivot clamp.
What the stand-in cannot see (timing, bank conflicts, a race between two
barriers) stays with the card. Skips where there is no ``g++`` with C++20's
``<barrier>``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.ops import kernels

from test_torch_kernels_gpu import (ALPHA, BOX02, NU2, P, P2, SIGMA,
                                     _clamp_inputs, _segment_inputs,
                                     _woodbury_inputs)

EMU = Path(__file__).resolve().parent / "cuda_emu"
# the one declaration of the sources that has no meaning on the CPU: the
# dynamic shared memory of the block, which the stand-in hands out per block
DYNAMIC_SMEM = ("extern __shared__ float4 dyn_smem_f4[];",
                "float4* dyn_smem_f4 = emu::block_smem();")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{name: ctypes library}`` of the three sources compiled for the
    CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    probe = out / "probe.cpp"
    probe.write_text("#include <barrier>\nstd::barrier<> b(1);\n"
                     "int main() { b.arrive_and_wait(); }\n")
    flags = ["-std=c++20", "-O1", "-pthread", "-Wno-unknown-pragmas"]
    if subprocess.run([gxx, *flags, "-o", str(out / "probe"), str(probe)],
                      capture_output=True).returncode:
        pytest.skip("needs a g++ with C++20's <barrier>")
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
    libs = {}
    for name, source in kernels.SOURCES.items():
        cpp = out / source.replace(".cu", ".cpp")
        so = out / f"{name}.so"
        proc = subprocess.run(
            [gxx, *flags, "-shared", "-fPIC", "-I", str(EMU), "-o", str(so),
             str(cpp)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        libs[name] = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["admm_segment"].admm_segment_launch.argtypes = (
        [p] * 12 + [i, i, f, f, f, i, p])
    libs["woodbury_ns"].woodbury_ns_launch.argtypes = (
        [p] * 5 + [i, i, i, i, f, i, i, p])
    libs["woodbury_ns"].woodbury_ns_smem_bytes.argtypes = [i, i, i, i]
    libs["woodbury_ns"].woodbury_ns_general_launch.argtypes = (
        [p] * 6 + [i, i, i, i, f, i, p])
    libs["woodbury_ns"].woodbury_ns_general_smem_bytes.argtypes = [i]
    libs["woodbury_ns"].woodbury_ns_general_scratch_floats.argtypes = [i, i]
    libs["woodbury_ns"].woodbury_ns_general_scratch_floats.restype = \
        ctypes.c_long
    libs["admm_segment_grouped"].admm_segment_grouped_launch.argtypes = (
        [p] * 12 + [i, i, i, f, f, f, i, p])
    return libs


def _segment(lib, ins, length):
    outs = [torch.full_like(ins[6], float("nan")) for _ in range(3)]
    B, p = ins[0].shape[0], ins[0].shape[-1]
    rc = lib.admm_segment_launch(
        *(t.data_ptr() for t in ins + outs), B, p, SIGMA, ALPHA, 1.0 - ALPHA,
        length, None)
    return rc, outs


def _grouped(lib, ins, length, group):
    outs = [torch.full_like(ins[6], float("nan")) for _ in range(3)]
    B, p = ins[0].shape[0], ins[0].shape[-1]
    rc = lib.admm_segment_grouped_launch(
        *(t.data_ptr() for t in ins + outs), B, p, group, SIGMA, ALPHA,
        1.0 - ALPHA, length, None)
    return rc, outs


def _general(lib, ins, box0, n_box, n_ns):
    out = torch.full_like(ins[0], float("nan"))
    B, p = ins[0].shape[0], ins[0].shape[-1]
    # NaN-filled: a read of scratch that was never written shows
    scratch = torch.full(
        (B * lib.woodbury_ns_general_scratch_floats(p, n_box),),
        float("nan"))
    rc = lib.woodbury_ns_general_launch(
        *(t.data_ptr() for t in ins + [out, scratch]), B, p, box0, n_box,
        SIGMA, n_ns, None)
    assert rc == 0
    return out


def _woodbury(lib, ins, box0, n_box, n_ns, cluster):
    out = torch.full_like(ins[0], float("nan"))
    rc = lib.woodbury_ns_launch(
        *(t.data_ptr() for t in ins + [out]), ins[0].shape[0],
        ins[0].shape[-1], box0, n_box, SIGMA, n_ns, cluster, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("p,nu,box0", [(P, 120, 96), (P2, NU2, BOX02)],
                         ids=["registers", "streamed"])
def test_admm_segment_source_matches_twin(emulated, p, nu, box0):
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
    # a padded size that is no multiple of 32 is refused
    odd = [torch.zeros(1, 100, 100)] + [torch.zeros(1, 100)] * 8
    assert _segment(lib, odd, 1)[0] != 0


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
    and a box of 240 at P = 256 now agree with the twin on the general
    route, which refuses only P above 1024 and an invalid box."""
    lib = emulated["woodbury_ns"]
    for p, n_box, cluster in ((P, 24, 2), (P2, 48, 1), (384, 24, 8),
                              (P2, 240, 8)):
        m, v = torch.zeros(1, p, p), torch.zeros(1, p)
        rc = lib.woodbury_ns_launch(
            *(t.data_ptr() for t in (m, m, v, v, torch.empty_like(m))), 1, p,
            0, n_box, SIGMA, 1, cluster, None)
        assert rc != 0, (p, n_box, cluster)
    for p, nu, box0 in ((384, 280, 256), (P2, NU2, 0)):
        _, _, ins = _woodbury_inputs(13, 1, nu, box0, p=p)
        ins = [torch.as_tensor(v).contiguous() for v in ins.values()]
        kw = dict(box0=box0, n_box=nu - box0, n_ns=0)
        ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
        got = _general(lib, ins, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-6)
    for p, box0, n_box in ((1152, 0, 24), (P, 120, 24), (P, 0, 0)):
        m, v = torch.zeros(1, p, p), torch.zeros(1, p)
        rc = lib.woodbury_ns_general_launch(
            *(t.data_ptr() for t in (m, m, v, v, torch.empty_like(m), m)), 1,
            p, box0, n_box, SIGMA, 1, None)
        assert rc != 0, (p, box0, n_box)


@pytest.mark.parametrize("p,nu,box0,n_ns",
                         [(384, 288, 208, 1), (640, 528, 520, 0),
                          (384, 384, 84, 0), (P2, 132, 0, 2)],
                         ids=["p384-box80", "p640-box8", "gj-in-scratch",
                              "p256-box132"])
def test_woodbury_ns_general_source_matches_twin(emulated, p, nu, box0,
                                                 n_ns):
    """The general route: P = 384 and P = 640, the elimination in the device
    scratch (n_box 300 > 231), and the long horizon's box of 132 at
    P = 256 with two Newton–Schulz steps, at B = 2."""
    _, _, ins = _woodbury_inputs(14, 2, nu, box0, p=p)
    ins = [torch.as_tensor(v).contiguous() for v in ins.values()]
    kw = dict(box0=box0, n_box=nu - box0, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins, sigma=SIGMA, **kw)
    got = _general(emulated["woodbury_ns"], ins, **kw)
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


@pytest.mark.parametrize("batch,p", [(3, P), (5, P), (2, P2), (2, 384)],
                         ids=["registers", "registers-odd", "streamed",
                              "streamed-384"])
def test_admm_segment_grouped_source_matches_twin(emulated, batch, p):
    """Both variants of the grouped segment, every group giving the same
    result."""
    nu, box0 = (120, 96) if p == P else (p - 16, p - 64)
    ins = [torch.as_tensor(v).contiguous() for v in
           _segment_inputs(15, batch, nu=nu, box0=box0, p=p).values()]
    ref = kernels.admm_segment_plain(*ins, sigma=SIGMA, alpha=ALPHA, length=4)
    lib = emulated["admm_segment_grouped"]
    runs = [_grouped(lib, ins, 4, g) for g in (1, batch)]
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
    # 32 or above 1024
    for batch, p, group in ((32, P, 5), (1, 100, 1), (1, 1056, 1)):
        bad = [torch.zeros(batch, p, p)] + [torch.zeros(batch, p)] * 8
        assert _grouped(lib, bad, 1, group)[0] != 0


def test_woodbury_layout_of_the_source_matches_the_plan(emulated):
    lib = emulated["woodbury_ns"]
    for n_box in range(1, kernels.WOODBURY_MAX_P + 1):
        assert lib.woodbury_ns_general_smem_bytes(n_box) == \
            kernels.woodbury_general_smem_bytes(n_box)
        for p in (n_box, kernels.WOODBURY_MAX_P):
            assert lib.woodbury_ns_general_scratch_floats(p, n_box) == \
                kernels.woodbury_general_scratch_floats(p, n_box)
    fn = lib.woodbury_ns_smem_bytes
    for p, clusters in kernels.WOODBURY_CLUSTERS.items():
        for n_box in range(1, kernels.WOODBURY_MAX_BOX + 1):
            for n_ns in (0, 1):
                for c in clusters:
                    assert fn(p, n_box, n_ns, c) == \
                        kernels.woodbury_smem_bytes(n_box, n_ns, c, p), \
                        (p, n_box, n_ns, c)
