"""The port's kernels' plain twins against the Pallas kernels they replace.

On the CPU each wrapper in ``ironcub_mpc_tpu_torch.ops.kernels`` runs its
plain PyTorch twin; that twin is held against ``pallas_solve.admm_segment``,
``pallas_solve.admm_segment_grouped`` and ``pallas_solve.woodbury_ns`` run
as tests/test_pallas_solve.py runs them (interpret mode, jitted, vmapped), at the shapes and tolerances of
that file. The CUDA kernels themselves are held against the twins on a
card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.ops import pallas_solve
from ironcub_mpc_tpu.qp import condensed as jcond

from ironcub_mpc_tpu_torch.ops import kernels

from test_torch_kernels_gpu import (ALPHA, NU, P, SHAPES, SIGMA,
                                     _segment_inputs, _woodbury_inputs)


def _pallas_segment(ins, length):
    one = lambda *a: pallas_solve.admm_segment(  # noqa: E731
        *(v if v.ndim == 2 else v[None, :] for v in a), sigma=SIGMA,
        alpha=ALPHA, length=length)
    outs = jax.jit(jax.vmap(one))(*(jnp.asarray(v) for v in ins.values()))
    return [np.asarray(o)[:, 0] for o in outs]


def test_admm_segment_twin_matches_pallas():
    batch, length = 3, 17
    ins = _segment_inputs(0, batch)
    ref = _pallas_segment(ins, length)
    before = kernels.admm_segment.launches
    got = kernels.admm_segment(*(torch.as_tensor(v) for v in ins.values()),
                               sigma=SIGMA, alpha=ALPHA, length=length)
    assert kernels.admm_segment.launches == before   # the twin ran
    # the tolerances of test_pallas_solve::test_admm_segment_matches_reference
    for g, r, atol in zip(got, ref, (2e-4, 2e-4, 2e-3)):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol)


@pytest.mark.parametrize("group", [8, 4])
def test_admm_segment_grouped_twin_matches_pallas(group):
    """B = 16 scenarios, ``group`` per program, against the Pallas grouped
    kernel in interpret mode; the tolerances of
    test_pallas_solve::test_admm_segment_grouped_matches_single."""
    batch, length = 16, 9
    ins = _segment_inputs(7, batch)
    ref = pallas_solve.admm_segment_grouped(
        *(jnp.asarray(v) for v in ins.values()), sigma=SIGMA, alpha=ALPHA,
        length=length, group=group)
    tins = [torch.as_tensor(v) for v in ins.values()]
    before = kernels.admm_segment_grouped.launches
    got = kernels.admm_segment_grouped(*tins, sigma=SIGMA, alpha=ALPHA,
                                       length=length, group=group)
    assert kernels.admm_segment_grouped.launches == before   # the twin ran
    for g, r in zip(got, ref):
        assert g.shape == (batch, P)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)
    # and against the single-scenario twin on the same inputs
    single = kernels.admm_segment(*tins, sigma=SIGMA, alpha=ALPHA,
                                  length=length)
    for g, r in zip(got, single):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)


def test_admm_segment_grouped_refuses_a_ragged_batch():
    """``B % group`` must be 0, on the twin's path as on the JAX wrapper."""
    ins = _segment_inputs(7, 6)
    with pytest.raises(ValueError, match="not divisible"):
        pallas_solve.admm_segment_grouped(
            *(jnp.asarray(v) for v in ins.values()), sigma=SIGMA,
            alpha=ALPHA, length=2, group=4)
    tins = [torch.as_tensor(v) for v in ins.values()]
    for fn in (kernels.admm_segment_grouped,
               kernels.admm_segment_grouped_plain):
        with pytest.raises(ValueError, match="batch 6 not divisible by "
                                             "group 4"):
            fn(*tins, sigma=SIGMA, alpha=ALPHA, length=2, group=4)
    with pytest.raises(ValueError, match="group must be >= 1"):
        kernels.admm_segment_grouped(*tins, sigma=SIGMA, alpha=ALPHA,
                                     length=2, group=0)
    out = kernels.admm_segment_grouped(*tins, sigma=SIGMA, alpha=ALPHA,
                                       length=2, group=3)
    assert out[0].shape == (6, P)


@pytest.mark.parametrize("n_ns", [0, 1, 2])
@pytest.mark.parametrize("nu,box0", SHAPES, ids=["stock", "wide"])
def test_woodbury_ns_twin_matches_pallas(nu, box0, n_ns):
    batch = 2
    nb = nu - box0
    H, rho_new, ins = _woodbury_inputs(2 + box0, batch, nu, box0)
    one = lambda k, h, d, r: pallas_solve.woodbury_ns(  # noqa: E731
        k, h, d[:, None], r[:, None], box0=box0, n_box=nb, sigma=SIGMA,
        n_ns=n_ns)
    ref = np.asarray(jax.jit(jax.vmap(one))(
        *(jnp.asarray(v) for v in ins.values())))
    before = kernels.woodbury_ns.launches
    got = kernels.woodbury_ns(*(torch.as_tensor(v) for v in ins.values()),
                              box0=box0, n_box=nb, sigma=SIGMA,
                              n_ns=n_ns).numpy()
    assert kernels.woodbury_ns.launches == before
    # the tolerances of test_pallas_solve::test_woodbury_ns_matches_reference
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    assert np.all(got[:, nu:, :] == 0) and np.all(got[:, :, nu:] == 0)
    K = H + SIGMA * np.eye(nu) + np.pad(rho_new, ((0, 0), (box0, 0)))[
        :, None, :] * np.eye(nu)
    resid = got[:, :nu, :nu] @ K - np.eye(nu)
    assert np.abs(resid).max() < 1e-3


def test_gj_inverse_matches_jax_including_pivot_clamp():
    rng = np.random.default_rng(9)
    M = (np.eye(6) + 0.3 * rng.normal(size=(4, 6, 6))).astype(np.float32)
    M[1, 0, 0] = 0.0                       # zero pivot: clamped to +1e-12
    M[2, 0, 0] = -1e-13                    # tiny negative: clamped to -1e-12
    got = kernels.gj_inverse(torch.as_tensor(M)).numpy()
    ref = np.stack([np.asarray(jcond._gj_inverse(jnp.asarray(m))) for m in M])
    ok = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    scale = np.maximum(np.abs(ref[ok]), 1.0)
    assert np.max(np.abs(got[ok] - ref[ok]) / scale) < 1e-5


def test_wrappers_raise_on_a_device_without_kernel():
    """A wrapper takes its twin only for CPU tensors; anything else that is
    not CUDA is refused, never computed by the twin."""
    ins = {k: torch.as_tensor(v).to("meta")
           for k, v in _segment_inputs(0, 1).items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.admm_segment(*ins.values(), sigma=SIGMA, alpha=ALPHA,
                             length=3)
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.admm_segment_grouped(*ins.values(), sigma=SIGMA, alpha=ALPHA,
                                     length=3, group=1)
    m = torch.empty((1, P, P), device="meta")
    v = torch.empty((1, P), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.woodbury_ns(m, m, v, v, box0=96, n_box=24, sigma=SIGMA,
                            n_ns=1)
    with pytest.raises(ValueError, match="invalid"):
        kernels.woodbury_ns(m, m, v, v, box0=120, n_box=24, sigma=SIGMA,
                            n_ns=1)


# ---------------------------------------------------------------------------
# the launch plans (pure Python: which variant, how many threads, how much
# shared memory, what cluster) and their agreement with the CUDA sources
# ---------------------------------------------------------------------------


def _cuda_constants(source):
    """The namespace-scope ``constexpr int kName = <int or product of ints
    and names>;`` of a CUDA source as ``{name: value}``."""
    text = (kernels.CSRC / source).read_text()
    out = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", text,
                                 re.M):
        out[name] = int(eval(expr, {"__builtins__": {}}, dict(out)))
    return text, out


@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("p,variant", [(128, "registers"),
                                       (256, "streamed")])
def test_segment_plan_fits_the_card(p, variant, batch):
    plan = kernels.segment_plan(batch, p)
    assert plan["variant"] == variant
    assert plan["blocks"] == batch
    assert 0 < plan["threads"] <= kernels.MAX_THREADS
    assert plan["threads"] % 32 == 0
    assert 0 < plan["smem_bytes"] <= kernels.MAX_SMEM


def test_segment_plan_refuses_what_the_kernel_does_not_take():
    assert kernels.segment_plan(4, 192)["variant"] == "streamed"
    assert kernels.segment_plan(4, 1024)["variant"] == "streamed"
    for p in (0, 100, 130, 2048):
        with pytest.raises(ValueError, match="multiple of 32"):
            kernels.segment_plan(1, p)


def test_segment_plan_matches_the_cuda_source():
    text, c = _cuda_constants("admm_segment.cu")
    assert c["kRegP"] == kernels.LANE
    assert c["kRegThreads"] == kernels.SEGMENT_REG_THREADS
    plan = kernels.segment_plan(1, kernels.LANE)
    assert plan["threads"] == c["kRegThreads"]
    # static shared memory of the register variant: rhs, double-buffered
    assert "__shared__ float4 s_rhs[2][kRegP / 4];" in text
    assert plan["smem_bytes"] == 2 * c["kRegP"] * 4
    # the launcher picks the variant by the same rule as the plan, and the
    # streamed variant runs one thread per coordinate on [P] floats of rhs
    assert "if (P == kRegP) {" in text
    assert "cfg.blockDim = dim3(P);" in text
    assert "cfg.dynamicSmemBytes = sizeof(float) * P;" in text


@pytest.mark.parametrize("n_ns", [0, 1])
@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("p,n_box", [(128, 24), (128, 120), (256, 48),
                                     (256, 120)])
def test_woodbury_plan_fits_the_card(p, n_box, batch, n_ns):
    plan = kernels.woodbury_plan(batch, p, n_box, n_ns)
    c = plan["cluster"]
    # the tuned routes keep every shape they took before the general route
    assert plan["route"] == "tuned" and plan["scratch_floats"] == 0
    assert c in kernels.WOODBURY_CLUSTERS[p] and c <= kernels.MAX_CLUSTER
    assert plan["blocks"] == batch * c
    assert plan["threads"] == kernels.WOODBURY_THREADS <= kernels.MAX_THREADS
    assert 0 < plan["smem_bytes"] <= kernels.MAX_SMEM
    # the rule: at the stock size a lone scenario with a product to split
    # takes 8 SMs, any other batch one block a scenario; twice the stock
    # size fits a cluster of 8 only
    if p == 256:
        assert c == 8
    elif batch == 1 and (n_ns > 0 or n_box > 32):
        assert c == 8 and plan["blocks"] <= kernels.NUM_SMS
    else:
        assert c == 1
    # every cluster size the wrapper can be told to launch fits as well
    for forced in kernels.WOODBURY_CLUSTERS[p]:
        got = kernels.woodbury_plan(batch, p, n_box, n_ns, forced)
        assert got["cluster"] == forced
        assert got["smem_bytes"] <= kernels.MAX_SMEM


def test_woodbury_plan_refuses_what_the_kernel_does_not_take():
    for p in (64, 192, 1152, 2048):
        with pytest.raises(ValueError, match="multiple of 128 up to 1024"):
            kernels.woodbury_plan(1, p, 24, 1)
    for p, c in ((128, 0), (128, 2), (128, 4), (128, 16), (256, 1)):
        with pytest.raises(ValueError, match="cluster size"):
            kernels.woodbury_plan(1, p, 24, 1, c)
    # P = 384 and a box wider than 128 go to the general route, where no
    # cluster size can be forced
    for p, n_box in ((384, 24), (256, 129)):
        assert kernels.woodbury_plan(1, p, n_box, 1)["route"] == "general"
        with pytest.raises(ValueError, match="general route"):
            kernels.woodbury_plan(1, p, n_box, 1, 8)
    # a lone scenario keeps its cluster up to the batch whose blocks still
    # have an SM each
    assert kernels.woodbury_plan(16, 128, 24, 1)["cluster"] == 8
    assert kernels.woodbury_plan(17, 128, 24, 1)["cluster"] == 1
    # no box the elimination takes outgrows a block's shared memory
    worst = max(kernels.woodbury_smem_bytes(n, ns, c, p)
                for p, cs in kernels.WOODBURY_CLUSTERS.items() for c in cs
                for n in range(1, kernels.WOODBURY_MAX_BOX + 1)
                for ns in (0, 1))
    assert worst <= kernels.MAX_SMEM


@pytest.mark.parametrize("batch", [1, 16, 64])
@pytest.mark.parametrize("p,n_box", [(256, 129), (256, 132), (256, 231), (256, 232),
                                     (384, 80), (640, 8), (640, 528),
                                     (1024, 1024)])
def test_woodbury_plan_general_route(p, n_box, batch):
    """One block a scenario with a device scratch, every shape the tuned
    routes do not take up to P = 1024: the shared memory fits a block, the
    Gauss–Jordan matrix moves to the scratch above n_box 231."""
    plan = kernels.woodbury_plan(batch, p, n_box, 1)
    assert plan["route"] == "general" and plan["cluster"] == 1
    assert plan["blocks"] == batch
    assert plan["threads"] == kernels.WOODBURY_THREADS
    assert 0 < plan["smem_bytes"] <= kernels.MAX_SMEM
    in_smem = n_box <= 231
    assert plan["scratch_floats"] == batch * (
        3 * p * p + (0 if in_smem else n_box * n_box))
    assert (plan["smem_bytes"] >= 4 * n_box * n_box) == in_smem


def test_woodbury_general_layout_matches_the_cuda_source():
    """The general route's shared memory and scratch, from the constants
    parsed out of csrc/woodbury_ns.cu: product tiles A [32, 65] and
    B [32, 64], the pivot row and column, the Gauss–Jordan matrix while it
    fits."""
    text, c = _cuda_constants("woodbury_ns.cu")
    assert c["kMaxGeneralP"] == kernels.WOODBURY_MAX_P
    assert c["kGenLdA"] == c["kGenTile"] + 1
    assert c["kGenTileFloats"] == kernels.WOODBURY_GENERAL_TILE_FLOATS == \
        c["kGenDepth"] * c["kGenLdA"] + c["kGenDepth"] * c["kGenTile"]
    assert "return 3L * P * P + (general_gj_in_smem(n) ? 0" in text
    for n in range(1, 1025):
        vec = 2 * ((n + 3) // 4 * 4)
        fits = 4 * (c["kGenTileFloats"] + vec + n * n) <= c["kMaxSmem"]
        assert fits == (n <= 231)
        assert kernels.woodbury_general_smem_bytes(n) == 4 * (
            c["kGenTileFloats"] + vec + (n * n if fits else 0))


@pytest.mark.parametrize("p", [128, 256, 384])
@pytest.mark.parametrize("batch,group", [(1, 1), (256, 8), (265, 5),
                                         (512, 16), (1056, 8)])
def test_grouped_plan_fits_the_card(p, batch, group):
    """K⁻¹ in the registers of one block a scenario at P = 128, any other
    size streamed, as segment_plan says; ``group`` changes nothing but the
    check that it divides B."""
    plan = kernels.grouped_plan(batch, p, group)
    assert plan == kernels.grouped_plan(batch, p, 1) == \
        kernels.segment_plan(batch, p)
    assert plan["variant"] == ("registers" if p == 128 else "streamed")
    assert plan["blocks"] == batch
    assert plan["threads"] <= kernels.MAX_THREADS


def test_grouped_plan_refuses_what_the_kernel_does_not_take():
    for p in (0, 100, 1056):
        with pytest.raises(ValueError, match="multiple of 32"):
            kernels.grouped_plan(8, p, 1)
    with pytest.raises(ValueError, match="batch 32 not divisible by group 5"):
        kernels.grouped_plan(32, 128, 5)
    with pytest.raises(ValueError, match="group must be >= 1"):
        kernels.grouped_plan(32, 128, 0)


def test_grouped_plan_matches_the_cuda_source():
    """The grouped source launches as segment_plan says: the register
    variant at P = 128 (512 threads, 1 KB of static shared memory), else
    the shared streamed kernel."""
    text, c = _cuda_constants("admm_segment_grouped.cu")
    assert c["kRegP"] == kernels.LANE
    assert c["kThreads"] == kernels.SEGMENT_REG_THREADS
    assert c["kMaxP"] == kernels.MAX_THREADS
    assert "__shared__ float4 s_rhs[2][kRegP / 4];" in text
    plan = kernels.grouped_plan(1, kernels.LANE, 1)
    assert plan["smem_bytes"] == 2 * c["kRegP"] * 4
    assert "if (P == kRegP) {" in text
    assert "cfg.blockDim = dim3(kThreads);" in text
    assert "cfg.blockDim = dim3(P);" in text
    assert "cfg.dynamicSmemBytes = sizeof(float) * P;" in text


def _layout_bytes(c, P, n, n_ns, cluster):
    """The regions of csrc/woodbury_ns.cu's header comment, from the
    constants parsed out of the source."""
    R = P // cluster
    n8, n4 = (n + 7) // 8 * 8, (n + 3) // 4 * 4
    x = R * P
    g_then_t = (max(R, n8) if n_ns else n8) * P
    u = R * n4
    k_strip = R * P if n_ns else 0
    gathered = 0 if cluster == 1 else P * P if P == c["kLane"] else R * P
    fixed = x + g_then_t + c["kVecFloats"] + gathered
    apart = 4 * (fixed + u + k_strip)
    return apart if apart <= c["kMaxSmem"] else 4 * (fixed + max(u, k_strip))


def test_woodbury_smem_bytes_matches_the_cuda_source():
    text, c = _cuda_constants("woodbury_ns.cu")
    assert c["kLane"] == kernels.LANE == kernels.WOODBURY_MAX_BOX
    assert c["kThreads"] == kernels.WOODBURY_THREADS
    assert c["kMaxSmem"] == kernels.MAX_SMEM
    assert c["kVecFloats"] == kernels.WOODBURY_VEC_FLOATS
    assert "n_box > kLane" in text
    built = {}
    for p, cluster in re.findall(r"err = launch<(\d+), (\d+)>\(", text):
        built.setdefault(int(p), []).append(int(cluster))
    assert {p: tuple(cs) for p, cs in built.items()} == \
        kernels.WOODBURY_CLUSTERS
    for P, clusters in kernels.WOODBURY_CLUSTERS.items():
        for n in (1, 7, 24, 32, 33, 48, 100, 120, 128):
            for n_ns in (0, 1, 2):
                for cluster in clusters:
                    assert kernels.woodbury_smem_bytes(n, n_ns, cluster, P) \
                        == _layout_bytes(c, P, n, n_ns, cluster), \
                        (P, n, n_ns, cluster)
    # the stock refresh keeps the K strip beside U, the wide box cannot
    assert kernels.woodbury_smem_bytes(24, 1, 1) == 4 * (
        3 * 128 * 128 + 128 * 24 + c["kVecFloats"])
    assert kernels.woodbury_smem_bytes(120, 1, 1) == 4 * (
        3 * 128 * 128 + c["kVecFloats"])
