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

from test_torch_kernels_gpu import (ALPHA, BOX02, NU, NU2, P, P2, SHAPES,
                                     SIGMA, _segment_inputs, _woodbury_inputs)


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


def test_admm_segment_twin_matches_pallas_at_p256():
    """Twice the stock horizon (P = 256, where the card takes the cluster
    route), the tolerances of test_admm_segment_twin_matches_pallas."""
    batch, length = 2, 9
    ins = _segment_inputs(31, batch, nu=NU2, box0=BOX02, p=P2)
    ref = _pallas_segment(ins, length)
    got = kernels.admm_segment(*(torch.as_tensor(v) for v in ins.values()),
                               sigma=SIGMA, alpha=ALPHA, length=length)
    for g, r, atol in zip(got, ref, (2e-4, 2e-4, 2e-3)):
        assert g.shape == (batch, P2)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol)


def test_admm_segment_grouped_twin_matches_pallas_at_p256():
    """B = 4 at P = 256, two scenarios a program, against the Pallas
    grouped kernel in interpret mode (the tolerances of
    test_admm_segment_grouped_twin_matches_pallas)."""
    batch, length = 4, 9
    ins = _segment_inputs(32, batch, nu=NU2, box0=BOX02, p=P2)
    ref = pallas_solve.admm_segment_grouped(
        *(jnp.asarray(v) for v in ins.values()), sigma=SIGMA, alpha=ALPHA,
        length=length, group=2)
    got = kernels.admm_segment_grouped(
        *(torch.as_tensor(v) for v in ins.values()), sigma=SIGMA,
        alpha=ALPHA, length=length, group=2)
    for g, r in zip(got, ref):
        assert g.shape == (batch, P2)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)


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
@pytest.mark.parametrize("p,route", [(128, "registers"), (256, "cluster"),
                                     (1152, "spread"), (4224, "spread")])
def test_segment_plan_fits_the_card(p, route, batch):
    plan = kernels.segment_plan(batch, p, 5)
    assert plan["route"] == route
    per = {"registers": 1, "cluster": plan["cluster"],
           "spread": p // max(plan["spread_cols"], 1)}[route]
    assert plan["blocks"] == batch * per
    assert 0 < plan["threads"] <= kernels.MAX_THREADS
    assert plan["threads"] % 32 == 0
    assert 0 < plan["smem_bytes"] <= kernels.MAX_SMEM
    # the spread route: rhs in a double-buffered device scratch of 2·B·P
    # floats, the state in the outputs, one kernel an iteration
    spread = route == "spread"
    assert plan["scratch_floats"] == (2 * batch * p if spread else 0)
    assert plan["kernels"] == (5 if spread else 1)
    if route == "cluster":
        # the whole strip on chip for the segment, in registers at P = 256;
        # a lone scenario on 8 blocks, a batch on 2 (one block of 512
        # threads a scenario and SM)
        assert plan["kinv_in_registers"] == (p == kernels.SEGMENT_REG_P)
        assert plan["threads"] == 32 * (p // plan["cluster"]) // 8
        assert plan["cluster"] == (8 if batch == 1 else 2)
    if spread:
        # the widest strip whose blocks cover half the card's 132 SMs
        assert plan["spread_cols"] == {(1152, 1): 16, (4224, 1): 32}.get(
            (p, batch), 32)


def test_segment_plan_refuses_what_the_kernel_does_not_take():
    """Every positive multiple of 32 runs: on a cluster whose shared memory
    holds every strip whole (P up to 640), the largest whose B·C blocks are
    one wave of the card (else the smallest), or spread over the card
    beyond, with device memory its only cap. A size that is no positive
    multiple of 32 is refused, and so is a forced choice the launcher does
    not take."""
    for p in range(32, 4320, 32):
        if p == kernels.LANE:
            continue
        for batch in (1, 64, 256):
            plan = kernels.segment_plan(batch, p, 5)
            c = plan["cluster"]
            whole = [k for k in kernels.SEGMENT_CLUSTERS
                     if kernels.segment_cluster_takes(p, k)]
            assert (plan["route"] == "cluster") == bool(whole), p
            if whole:
                assert c == (max(whole) if batch * max(whole) <=
                             kernels.NUM_SMS else min(whole))
                assert plan["smem_bytes"] == \
                    kernels.segment_cluster_smem_bytes(
                        p, c, plan["kinv_in_registers"])
            else:
                w = plan["spread_cols"]
                assert (c, plan["blocks"]) == (0, batch * p // w)
                assert w == 32 or batch * p // w < kernels.NUM_SMS
                assert w == 8 or 2 * batch * p // w >= kernels.NUM_SMS
    # the widest P a cluster holds whole (P = 640 on 8 blocks), and the
    # first it does not
    assert kernels.segment_plan(1, 640)["route"] == "cluster"
    assert kernels.segment_plan(1, 672)["route"] == "spread"
    assert kernels.segment_plan(1, 704)["route"] == "spread"
    for p in (0, -32, 100, 130):
        with pytest.raises(ValueError, match="multiple of 32"):
            kernels.segment_plan(1, p)
    # a cluster whose shared memory holds only part of each strip (P = 256
    # on one block, P = 640 on 4, P = 1152 on 8) is not taken
    for p, force in ((256, dict(cluster=3)), (288, dict(cluster=8)),
                     (640, dict(cluster=1)), (640, dict(cluster=4)),
                     (256, dict(cluster=1, kinv_in_registers=False)),
                     (1152, dict(cluster=8)),
                     (640, dict(cluster=8, kinv_in_registers=True)),
                     (256, dict(cluster=1, kinv_in_registers=True))):
        with pytest.raises(ValueError, match="does not take"):
            kernels.segment_plan(1, p, **force)
    with pytest.raises(ValueError, match="spread route"):
        kernels.segment_plan(1, 1152, cluster=0, kinv_in_registers=True)
    with pytest.raises(ValueError, match="strips of 64 columns"):
        kernels.segment_plan(1, 1152, spread_cols=64)
    with pytest.raises(ValueError, match="spread_cols forced"):
        kernels.segment_plan(1, 256, spread_cols=32)


def test_segment_plan_matches_the_cuda_source():
    text, c = _cuda_constants("admm_segment.cu")
    assert c["kRegP"] == kernels.LANE
    assert c["kRegThreads"] == kernels.SEGMENT_REG_THREADS
    plan = kernels.segment_plan(1, kernels.LANE)
    assert plan["threads"] == c["kRegThreads"]
    # static shared memory of the register route: rhs, double-buffered
    assert "__shared__ float4 s_rhs[2][kRegP / 4];" in text
    assert plan["smem_bytes"] == 2 * c["kRegP"] * 4
    # the launcher takes the register route at P = 128 and hands every
    # other size to the shared header's routes with the plan's choice
    assert "if (P == kRegP) {" in text
    assert "err = launch_segment_routes(B, stream, kinv," in text
    head, h = _cuda_constants("admm_segment.cuh")
    assert h["kSegCols"] == kernels.SEGMENT_COLS
    assert h["kSegPad"] == kernels.SEGMENT_PAD
    assert kernels.SEGMENT_CLUSTERS == (1, 2, 4, 8)
    assert h["kSegMaxThreads"] == kernels.MAX_THREADS
    assert h["kSegMaxSmem"] == kernels.MAX_SMEM
    assert h["kSegRegP"] == kernels.SEGMENT_REG_P
    assert h["kSegRegMaxThreads"] == kernels.SEGMENT_REG_MAX_THREADS
    assert h["kSpreadThreads"] == kernels.SEGMENT_SPREAD_THREADS
    assert "kStreamedMaxCoords" not in h
    # the cluster route: one block a strip of P / C columns, 8 a warp, the
    # strip's rows padded by kSegPad, rhs double-buffered beside them
    assert "cfg.gridDim = dim3(B * cluster);" in head
    assert "cfg.blockDim = dim3(32 * (P / cluster) / kSegCols);" in head
    assert "const size_t rows = regs ? 0 : static_cast<size_t>(P);" in head
    assert ("return sizeof(float) * (2 * static_cast<size_t>(P) +\n"
            "                          rows * (P / C + kSegPad));") in head
    assert "return seg_cluster_smem_bytes(P, C, regs) <= kSegMaxSmem;" in head
    assert "if (C != 1 && C != 2 && C != 4 && C != 8) return false;" in head
    assert ("if (threads > (regs ? kSegRegMaxThreads : kSegMaxThreads)) "
            "return false;") in head
    assert "if (regs && P != kSegRegP) return false;" in head
    assert "admm_segment_cluster_kernel<kSegRegRows>" in head
    assert "admm_segment_cluster_kernel<0>;" in head
    # the spread route: a strip of 32, 16 or 8 columns a block, a kernel an
    # iteration (one for length 0), refused without its scratch, with K⁻¹
    # in registers or with another width
    assert "cfg.gridDim = dim3(B * (P / kW));" in head
    assert "cfg.blockDim = dim3(kSpreadThreads);" in head
    assert "return length > 1 ? length : 1;" in head
    assert ("if (scratch == nullptr || kinv_regs) return "
            "cudaErrorInvalidValue;") in head
    assert "const size_t half = static_cast<size_t>(B) * P;" in head
    for w in kernels.SEGMENT_SPREAD_WIDTHS:
        assert f"case {w}: return launch_spread<{w}>(ADMM_SPREAD_ARGS);" \
            in head
    for kernel in ("admm_segment_spread_kernel<true, kW>",
                   "admm_segment_spread_kernel<false, kW>"):
        assert kernel in head
    for old in ("admm_segment_streamed_kernel", "admm_segment_wide_kernel"):
        assert old not in head + text


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
    for p in (0, 64, 192, 1160):
        with pytest.raises(ValueError, match="positive multiple of 128"):
            kernels.woodbury_plan(1, p, 24, 1)
    # above 1024 (refused before) the general route takes any multiple of 128
    for p in (1152, 2048):
        assert kernels.woodbury_plan(1, p, 24, 1)["route"] == "general"
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


@pytest.mark.parametrize("n_ns", [0, 1])
@pytest.mark.parametrize("batch", [1, 16, 64])
@pytest.mark.parametrize("p,n_box", [(256, 129), (256, 132), (256, 231), (256, 232),
                                     (384, 80), (640, 8), (640, 528),
                                     (1024, 1024), (1152, 8), (1152, 132)])
def test_woodbury_plan_general_route(p, n_box, batch, n_ns):
    """Every shape the tuned routes do not take, P = 1152 too: 4 + 2·n_ns
    launches, the products over (scenario, tile) with 64-wide tiles where
    they fill the card and 32-wide ones (four times the blocks) where they
    do not, the elimination of a box wider than 32 on the largest cluster at
    two blocks an SM (8 at B = 1 and 16, 4 at B = 64), of a narrower one on
    one block, M in the scratch only where no cluster holds it; every
    block's shared
    memory fits, and the scratch is G (rows padded to 32) plus W or two
    [P, P] buffers."""
    plan = kernels.woodbury_plan(batch, p, n_box, n_ns)
    assert plan["route"] == "general"
    stages = plan["stages"]
    assert plan["kernels"] == len(stages) == 4 + 2 * n_ns
    assert [s["name"] for s in stages] == (
        ["gauss_jordan", "W", "X"] + ["2I-KX", "X(2I-KX)"] * n_ns
        + ["symmetrise"])
    tile = plan["tile"]
    assert tile == (64 if batch * (p // 64) ** 2 >= kernels.NUM_SMS else 32)
    square = batch * (p // tile) ** 2
    assert [s["blocks"] for s in stages[1:-1]] == \
        [batch * -(-n_box // tile) * (p // tile)] + [square] * (1 + 2 * n_ns)
    sym = p // 32
    assert stages[-1]["blocks"] == batch * sym * (sym + 1) // 2
    assert plan["blocks"] == max(s["blocks"] for s in stages) > 1
    for s in stages[1:-1]:
        assert s["threads"] == plan["threads"] == \
            kernels.WOODBURY_GENERAL_THREADS
        assert s["smem_bytes"] == 4 * 2 * (tile * 36 + 32 * tile)
    # the elimination: a cluster whose shared memory holds M where one does
    c = plan["cluster"]
    gj = stages[0]
    assert gj["cluster"] == c and gj["blocks"] == batch * c
    assert gj["threads"] == kernels.WOODBURY_GJ_THREADS
    n32 = -(-n_box // 32) * 32
    fits = [k for k in (1, 2, 4, 8)
            if 4 * (2 * n32 + 2 * (-(-(-(-n_box // k)) // 4) * 4)
                    + -(-n_box // k) * n32) <= kernels.MAX_SMEM]
    assert plan["gj_in_smem"] == bool(fits) == (n_box <= 672)
    if not fits:
        assert c == 8
    elif n_box > 32:
        # the largest cluster at two blocks an SM, never fewer than hold M
        wide = max(k for k in (1, 2, 4, 8)
                   if batch * k <= 2 * kernels.NUM_SMS)
        assert wide == {1: 8, 16: 8, 64: 4}[batch]
        assert c == max(fits[0], wide)
    else:
        assert c == fits[0] == 1
    assert 0 < plan["smem_bytes"] == max(s["smem_bytes"] for s in stages) \
        <= kernels.MAX_SMEM
    assert plan["scratch_floats"] == batch * (
        n_box * n32 + (2 * p * p if n_ns else n_box * p))


def test_woodbury_general_layout_matches_the_cuda_source():
    """The general route's launches, shared memory and scratch, from the
    constants parsed out of csrc/woodbury_ns.cu: product blocks of 8 × 16
    threads over 32- or 64-wide tiles staged 32 deep (A rows padded by 4),
    two stages; elimination blocks of 256 on clusters of 1 to 8; 32 × 32
    symmetrisation tiles; the launcher refuses no padded size for its size
    (it refused P > 1024), only what the plan never asks for."""
    text, c = _cuda_constants("woodbury_ns.cu")
    assert c["kGenThreads"] == kernels.WOODBURY_GENERAL_THREADS == 8 * 16
    assert (c["kGenDepth"], c["kGenPad"]) == (
        kernels.WOODBURY_GENERAL_DEPTH, kernels.WOODBURY_GENERAL_PAD)
    assert c["kGjThreads"] == kernels.WOODBURY_GJ_THREADS
    assert (c["kSymTile"], c["kSymRows"]) == (
        kernels.WOODBURY_SYM_TILE, kernels.WOODBURY_SYM_ROWS)
    assert "(tile != 32 && tile != 64) || P % tile ||" in text
    assert "(C != 1 && C != 2 && C != 4 && C != 8) ||" in text
    assert kernels.WOODBURY_GENERAL_TILES == (32, 64)
    assert kernels.WOODBURY_GJ_CLUSTERS == (1, 2, 4, 8)
    assert "if (P < 1 || P % kSymTile || box0 < 0 || n_box < 1 ||" in text
    assert "return T * (kGenDepth + kGenPad) + kGenDepth * T;" in text
    assert "return 2L * round32(n) + 2L * round4(R) +" in text
    assert "return static_cast<long>(n) * round32(n);" in text
    assert "(n_ns > 0 ? 2L * P * P : static_cast<long>(n) * P);" in text
    for tile in kernels.WOODBURY_GENERAL_TILES:
        assert kernels.woodbury_general_product_smem_bytes(tile) == 4 * 2 * (
            tile * (c["kGenDepth"] + c["kGenPad"]) + c["kGenDepth"] * tile)
    for n in range(1, 1025):
        n32 = -(-n // 32) * 32
        for k in kernels.WOODBURY_GJ_CLUSTERS:
            R = -(-n // k)
            for in_smem in (True, False):
                assert kernels.woodbury_general_gj_smem_bytes(
                    n, k, in_smem) == 4 * (2 * n32 + 2 * (-(-R // 4) * 4)
                                           + (R * n32 if in_smem else 0))
    # a cluster of 8 holds M up to n_box 672; beyond, the scratch does
    assert kernels.woodbury_general_gj_smem_bytes(672, 8) <= c["kMaxSmem"]
    assert kernels.woodbury_general_gj_smem_bytes(673, 8) > c["kMaxSmem"]


@pytest.mark.parametrize("p", [128, 256, 384, 1152])
@pytest.mark.parametrize("batch,group", [(1, 1), (256, 8), (265, 5),
                                         (512, 16), (1056, 8)])
def test_grouped_plan_fits_the_card(p, batch, group):
    """K⁻¹ in the registers of one block a scenario at P = 128, a cluster up
    to P = 640 and spread beyond, as segment_plan says; ``group`` changes
    nothing but the check that it divides B."""
    plan = kernels.grouped_plan(batch, p, group, 5)
    assert plan == kernels.grouped_plan(batch, p, 1, 5) == \
        kernels.segment_plan(batch, p, 5)
    assert plan["route"] == ("registers" if p == 128 else
                             "cluster" if p <= 640 else "spread")
    assert plan["blocks"] == batch * (1 if p == 128 else
                                      p // plan["spread_cols"] if p > 640
                                      else plan["cluster"])
    assert plan["threads"] <= kernels.MAX_THREADS


def test_grouped_plan_refuses_what_the_kernel_does_not_take():
    # P = 1056 was refused before, and P = 14,560 while the wide variant
    # kept its state in shared memory; now only a size that is no positive
    # multiple of 32
    assert kernels.grouped_plan(8, 1056, 1)["route"] == "spread"
    assert kernels.grouped_plan(8, 14560, 1)["scratch_floats"] == \
        2 * 8 * 14560
    for p in (0, 100):
        with pytest.raises(ValueError, match="multiple of 32"):
            kernels.grouped_plan(8, p, 1)
    with pytest.raises(ValueError, match="batch 32 not divisible by group 5"):
        kernels.grouped_plan(32, 128, 5)
    with pytest.raises(ValueError, match="group must be >= 1"):
        kernels.grouped_plan(32, 128, 0)


def test_grouped_plan_matches_the_cuda_source():
    """The grouped source launches as segment_plan says: the register
    route at P = 128 (512 threads, 1 KB of static shared memory), else
    the shared header's cluster and spread routes."""
    text, c = _cuda_constants("admm_segment_grouped.cu")
    assert c["kRegP"] == kernels.LANE
    assert c["kThreads"] == kernels.SEGMENT_REG_THREADS
    assert "kMaxP" not in c
    assert "__shared__ float4 s_rhs[2][kRegP / 4];" in text
    plan = kernels.grouped_plan(1, kernels.LANE, 1)
    assert plan["smem_bytes"] == 2 * c["kRegP"] * 4
    assert "if (P == kRegP) {" in text
    assert "cfg.blockDim = dim3(kThreads);" in text
    assert "err = launch_segment_routes(B, stream, kinv," in text
    assert "launch_streamed" not in text


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
