"""The CUDA sources of admm_segment and woodbury_ns, run on the CPU.

A CUDA kernel has no interpret mode, so the card tests
(tests/test_torch_kernels_gpu.py) are the ones that hold the compiled
kernels against their twins. These tests hold the *logic* of the same
sources where there is no card: ``csrc/*.cu`` is compiled by ``g++`` against
the stand-in headers of tests/cuda_emu (a CUDA thread is an OS thread, a
barrier a ``std::barrier``, a shuffle an exchange through a per-warp array,
a peer block's shared memory a pointer), loaded through the same C interface
as the real library and compared with the plain PyTorch twins: both variants
of the segment, every padded size and cluster size of the refresh, both
Gauss–Jordan eliminations, ragged boxes and the pivot clamp. What the stand-in cannot see (timing, bank
conflicts, a race between two barriers) stays with the card. Skips where
there is no ``g++`` with C++20's ``<barrier>``.
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
# the one declaration of each source that has no meaning on the CPU: the
# dynamic shared memory of the block, which the stand-in hands out per block
DYNAMIC_SMEM = {
    "admm_segment": ("extern __shared__ float smem[];",
                     "float* smem = reinterpret_cast<float*>("
                     "emu::block_smem());"),
    "woodbury_ns": ("extern __shared__ float4 dyn_smem_f4[];",
                    "float4* dyn_smem_f4 = emu::block_smem();"),
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{name: ctypes library}`` of the two sources compiled for the CPU."""
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
    libs = {}
    for name, (decl, stand_in) in DYNAMIC_SMEM.items():
        text = (kernels.CSRC / kernels.SOURCES[name]).read_text()
        assert text.count(decl) == 1, f"{name}: {decl!r} not found once"
        cpp = out / f"{name}.cpp"
        cpp.write_text(text.replace(decl, stand_in))
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
    return libs


def _segment(lib, ins, length):
    outs = [torch.full_like(ins[6], float("nan")) for _ in range(3)]
    B, p = ins[0].shape[0], ins[0].shape[-1]
    rc = lib.admm_segment_launch(
        *(t.data_ptr() for t in ins + outs), B, p, SIGMA, ALPHA, 1.0 - ALPHA,
        length, None)
    return rc, outs


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
    lib = emulated["woodbury_ns"]
    for p, n_box, cluster in ((P, 24, 2), (P2, 48, 1), (384, 24, 8),
                              (P2, 240, 8)):
        m, v = torch.zeros(1, p, p), torch.zeros(1, p)
        rc = lib.woodbury_ns_launch(
            *(t.data_ptr() for t in (m, m, v, v, torch.empty_like(m))), 1, p,
            0, n_box, SIGMA, 1, cluster, None)
        assert rc != 0, (p, n_box, cluster)


def test_woodbury_layout_of_the_source_matches_the_plan(emulated):
    fn = emulated["woodbury_ns"].woodbury_ns_smem_bytes
    for p, clusters in kernels.WOODBURY_CLUSTERS.items():
        for n_box in range(1, kernels.WOODBURY_MAX_BOX + 1):
            for n_ns in (0, 1):
                for c in clusters:
                    assert fn(p, n_box, n_ns, c) == \
                        kernels.woodbury_smem_bytes(n_box, n_ns, c, p), \
                        (p, n_box, n_ns, c)
