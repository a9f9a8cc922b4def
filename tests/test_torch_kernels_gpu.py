"""The port's CUDA kernels against their plain PyTorch twins, on a card.

These tests import no JAX, so they run on a CUDA machine that has only the
port: ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py``.
Without a card they skip (marker ``gpu``); chip_smoke.py runs the same
comparison at the main path's shapes. The numpy input makers here are
shared with tests/test_torch_kernels.py, which holds the twins against the
Pallas kernels on the CPU.
"""

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.ops import kernels

NU, BOX0 = 40, 24
P = 128
SIGMA, ALPHA = 1e-6, 1.6
BIG = 1e30


def _spd(rng, batch, n):
    M = rng.normal(size=(batch, n, n))
    return (M @ M.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


def _kinv(H, rho_full):
    K = H + SIGMA * np.eye(H.shape[-1]) + rho_full[:, None, :] * np.eye(
        H.shape[-1])
    Ki = np.linalg.inv(K.astype(np.float64))
    return (0.5 * (Ki + Ki.transpose(0, 2, 1))).astype(np.float32)


def _pad_mat(A, p=P):
    return np.pad(A, ((0, 0), (0, p - A.shape[-1]), (0, p - A.shape[-1])))


def _full(v_box, nu, box0, fill=0.0, p=P):
    out = np.full((v_box.shape[0], p), fill, np.float32)
    out[:, nu:] = 0.0
    out[:, box0:nu] = v_box
    return out


def _segment_inputs(seed, batch, nu=NU, box0=BOX0, p=P):
    nb = nu - box0
    rng = np.random.default_rng(seed)
    H = _spd(rng, batch, nu)
    q = rng.normal(size=(batch, nu)).astype(np.float32)
    lb = -np.abs(rng.normal(size=(batch, nb))).astype(np.float32)
    ub = np.abs(rng.normal(size=(batch, nb))).astype(np.float32)
    rho = (np.abs(rng.normal(size=(batch, nb))) + 0.1).astype(np.float32)
    x0 = rng.normal(size=(batch, nu)).astype(np.float32)
    z0 = rng.normal(size=(batch, nb)).astype(np.float32)
    y0 = rng.normal(size=(batch, nb)).astype(np.float32)
    Kinv = _kinv(H, np.pad(rho, ((0, 0), (box0, 0))))
    return dict(
        Kinv_p=_pad_mat(Kinv, p), q_f=np.pad(q, ((0, 0), (0, p - nu))),
        lb_f=_full(lb, nu, box0, -BIG, p), ub_f=_full(ub, nu, box0, BIG, p),
        rho_f=_full(rho, nu, box0, p=p),
        rhoi_f=_full(1.0 / rho, nu, box0, p=p),
        x_f=np.pad(x0, ((0, 0), (0, p - nu))), z_f=_full(z0, nu, box0, p=p),
        y_f=_full(y0, nu, box0, p=p))


def _woodbury_inputs(seed, batch, nu, box0, p=P):
    nb = nu - box0
    rng = np.random.default_rng(seed)
    H = _spd(rng, batch, nu)
    rho_old = (np.abs(rng.normal(size=(batch, nb))) + 0.1).astype(np.float32)
    rho_new = (rho_old * rng.uniform(0.2, 5.0, (batch, nb))).astype(
        np.float32)
    Kinv = _kinv(H, np.pad(rho_old, ((0, 0), (box0, 0))))
    return H, rho_new, dict(
        Kinv_p=_pad_mat(Kinv, p), H_p=_pad_mat(H, p),
        d_f=_full(rho_new - rho_old, nu, box0, p=p),
        rho_f=_full(rho_new, nu, box0, p=p))


def _wide_inputs(seed, batch, p, n_box=64):
    """Segment inputs at a padded size too large for an inverse to be made
    cheaply: K⁻¹ stands in as ½I plus a small random matrix (a contraction,
    so the iterates stay bounded), the box on the last ``n_box``
    coordinates."""
    rng = np.random.default_rng(seed)
    K = (0.5 * np.eye(p) + 0.2 * rng.normal(size=(batch, p, p)) / np.sqrt(p)
         ).astype(np.float32)
    box0 = p - n_box
    rho = (np.abs(rng.normal(size=(batch, n_box))) + 0.1).astype(np.float32)
    vec = lambda: rng.normal(size=(batch, p)).astype(np.float32)  # noqa
    return dict(
        Kinv_p=K, q_f=vec(),
        lb_f=_full(-np.abs(vec()[:, :n_box]), p, box0, -BIG, p),
        ub_f=_full(np.abs(vec()[:, :n_box]), p, box0, BIG, p),
        rho_f=_full(rho, p, box0, p=p), rhoi_f=_full(1.0 / rho, p, box0, p=p),
        x_f=vec(), z_f=_full(vec()[:, :n_box], p, box0, p=p),
        y_f=_full(vec()[:, :n_box], p, box0, p=p))


# (nu, box0): the stock condensed layout (24 throttle knots at 96) and the
# joint-limits layout (the box covers all 120 inputs)
SHAPES = [(120, 96), (120, 0)]
# twice the stock horizon: nU = 240 pads to P = 256, 48 throttle knots at 192
NU2, BOX02, P2 = 240, 192, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py holds them against their twins there)")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch,length", [(1, 5), (256, 15)])
def test_admm_segment_cuda_matches_twin(cuda, batch, length):
    ins = {k: torch.as_tensor(v) for k, v in
           _segment_inputs(1, batch, nu=120, box0=96).items()}
    ref = kernels.admm_segment_plain(*ins.values(), sigma=SIGMA, alpha=ALPHA,
                                     length=length)
    before = kernels.admm_segment.launches
    got = kernels.admm_segment(*(v.to(cuda) for v in ins.values()),
                               sigma=SIGMA, alpha=ALPHA, length=length)
    torch.cuda.synchronize()
    assert kernels.admm_segment.launches == before + 1
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,length,group",
                         [(512, 40, 8), (512, 40, 16), (512, 40, 4),
                          (512, 40, 1), (256, 5, 8), (1056, 10, 8), (16, 7, 4),
                          (6, 3, 2), (5, 3, 1), (265, 4, 5)])
def test_admm_segment_grouped_cuda_matches_twin_and_single(cuda, batch,
                                                           length, group):
    """Every group, one wave (B ≤ 264) and more than one."""
    ins = {k: torch.as_tensor(v) for k, v in
           _segment_inputs(4, batch, nu=120, box0=96).items()}
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=length)
    ref = kernels.admm_segment_grouped_plain(*ins.values(), group=group, **kw)
    on_card = [v.to(cuda) for v in ins.values()]
    before = kernels.admm_segment_grouped.launches
    got = kernels.admm_segment_grouped(*on_card, group=group, **kw)
    single = kernels.admm_segment(*on_card, **kw)
    torch.cuda.synchronize()
    assert kernels.admm_segment_grouped.launches == before + 1
    for g, r, s in zip(got, ref, single):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-4)
        # the two kernels sum a column in different orders (8 × 4 row parts
        # joined by 5 shuffles here, 4 × 8 by 9 in admm_segment): they agree
        # as each agrees with the twin, not bit for bit
        np.testing.assert_allclose(g.cpu().numpy(), s.cpu().numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
def test_admm_segment_grouped_cuda_refuses_what_does_not_fit(cuda):
    """A group of 16 at B = 32 (refused by the previous design, one block of
    16 × 128 threads) now agrees with the twin; a group that does not divide
    the batch still raises, and nothing falls back to another kernel or to
    the twin."""
    cpu = [torch.as_tensor(v) for v in
           _segment_inputs(4, 32, nu=120, box0=96).values()]
    ins = [v.to(cuda) for v in cpu]
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=2)
    before = kernels.admm_segment_grouped.launches
    got = kernels.admm_segment_grouped(*ins, group=16, **kw)
    ref = kernels.admm_segment_grouped_plain(*cpu, group=16, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="not divisible"):
        kernels.admm_segment_grouped(*ins, group=5, **kw)
    assert kernels.admm_segment_grouped.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("batch,p,variant", [(64, P, "registers"),
                                             (64, P2, "cluster"),
                                             (8, 384, "cluster")])
def test_admm_segment_grouped_routes_cuda_match_twin(cuda, batch, p,
                                                     variant):
    """Each route of grouped_plan, every group that divides the batch
    giving the same result."""
    assert kernels.grouped_plan(batch, p, 8)["route"] == variant
    nu, box0 = (120, 96) if p == P else (p - 16, p - 64)
    ins = {k: torch.as_tensor(v) for k, v in
           _segment_inputs(9, batch, nu=nu, box0=box0, p=p).items()}
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5)
    ref = kernels.admm_segment_grouped_plain(*ins.values(), group=8, **kw)
    on_card = [v.to(cuda) for v in ins.values()]
    got = [kernels.admm_segment_grouped(*on_card, group=g, **kw)
           for g in (1, 8)]
    torch.cuda.synchronize()
    for a, b, r in zip(*got, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("p,box0", [(1152, 1132), (1152, 1008), (4224, None)],
                         ids=["p1152-box8", "p1152-box132", "p4224-wide"])
def test_segments_cuda_match_twin_above_1024(cuda, p, box0):
    """P = 1152 (refused before as above 1024) and P = 4224: both segment
    kernels spread a scenario's columns over the card, a launch an
    iteration, and agree with the twin (two scenarios at P = 4224, each
    with its own half of the scratch)."""
    plan = kernels.segment_plan(1, p, 5)
    assert (plan["route"], plan["threads"], plan["kernels"]) == (
        "spread", kernels.SEGMENT_SPREAD_THREADS, 5)
    raw = (_segment_inputs(17, 1, nu=1140, box0=box0, p=p) if box0
           else _wide_inputs(17, 2, p))
    ins = {k: torch.as_tensor(v) for k, v in raw.items()}
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5)
    ref = kernels.admm_segment_plain(*ins.values(), **kw)
    on_card = [v.to(cuda) for v in ins.values()]
    before = (kernels.admm_segment.launches,
              kernels.admm_segment_grouped.launches)
    got = kernels.admm_segment(*on_card, **kw)
    grouped = kernels.admm_segment_grouped(*on_card, group=1, **kw)
    torch.cuda.synchronize()
    assert (kernels.admm_segment.launches,
            kernels.admm_segment_grouped.launches) == (before[0] + 1,
                                                       before[1] + 1)
    for g, s, r in zip(got, grouped, ref):
        assert torch.equal(g, s)
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-4)


def _segment_inputs_card(seed, batch, nu, box0, p, dev):
    """``_segment_inputs``' layout with H = MMᵀ/nU + I and K⁻¹ made on the
    card in float64 (at P = 1152 and batch 256 the host's inverse takes
    minutes): a proper inverse, so the iterates stay O(1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev,  # noqa: E731
                                 dtype=torch.float64)
    nb = nu - box0
    M = rnd(batch, nu, nu)
    H = M @ M.mT / nu + torch.eye(nu, dtype=M.dtype, device=dev)
    rho = rnd(batch, nb).abs() + 0.1
    rho_full = torch.zeros(batch, nu, dtype=M.dtype, device=dev)
    rho_full[:, box0:] = rho
    Ki = torch.linalg.inv(H + SIGMA * torch.eye(nu, dtype=M.dtype, device=dev)
                          + torch.diag_embed(rho_full))
    Ki = torch.nn.functional.pad(0.5 * (Ki + Ki.mT), (0, p - nu, 0, p - nu))

    def full(v, fill=0.0):
        out = torch.full((batch, p), fill, dtype=M.dtype, device=dev)
        out[:, nu:] = 0.0
        out[:, box0:nu] = v
        return out

    q = torch.nn.functional.pad(rnd(batch, nu), (0, p - nu))
    x = torch.nn.functional.pad(rnd(batch, nu), (0, p - nu))
    ins = [Ki, q, full(-rnd(batch, nb).abs(), -BIG),
           full(rnd(batch, nb).abs(), BIG), full(rho), full(1.0 / rho), x,
           full(rnd(batch, nb)), full(rnd(batch, nb))]
    return [v.float().contiguous() for v in ins]


# every cluster size and place of K⁻¹ the cluster route takes at P = 256,
# P = 384 and 640 in shared memory, and the spread route's strip widths,
# forced
SEGMENT_FORCED = (
    [(P2, dict(cluster=c, kinv_in_registers=r)) for c in (2, 4, 8)
     for r in (False, True)]
    + [(384, dict(cluster=4)), (384, dict(cluster=8)), (640, {})]
    + [(1152, dict(cluster=0, spread_cols=w))
       for w in kernels.SEGMENT_SPREAD_WIDTHS]
    + [(P2, dict(cluster=0))])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("p,force", SEGMENT_FORCED,
                         ids=[f"p{p}-" + "-".join(f"{k}{int(v)}" for k, v in
                                                  f.items())
                              for p, f in SEGMENT_FORCED])
def test_segment_routes_cuda_match_twin(cuda, p, force, batch):
    """Every route and cluster size through both wrappers' launchers at
    B = 1, 64 and 256 against the twin (1e-4; the twin on the card), the
    two wrappers alike."""
    on_card = _segment_inputs_card(19, batch, p - 16, p - 150, p, cuda)
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5)
    ref = kernels.admm_segment_plain(*on_card, **kw)
    plan = kernels.segment_plan(batch, p, 5, **force)
    got = kernels._segment_launch("admm_segment", on_card, plan, **kw)
    grouped = kernels._segment_launch("admm_segment_grouped", on_card, plan,
                                      group=batch, **kw)
    torch.cuda.synchronize()
    for g, s, r in zip(got, grouped, ref):
        assert torch.equal(g, s)
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
def test_admm_segment_grouped_cuda_keeps_nan_in_its_lane(cuda):
    """A NaN in one scenario's state stays in that scenario; its neighbours
    match the twin."""
    ins = {k: torch.as_tensor(v) for k, v in
           _segment_inputs(3, 300, nu=120, box0=96).items()}
    ins["x_f"][5, 7] = float("nan")
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5, group=4)
    ref = kernels.admm_segment_grouped_plain(*ins.values(), **kw)
    got = kernels.admm_segment_grouped(*(v.to(cuda) for v in ins.values()),
                                       **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        g = g.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r.numpy()))
        assert np.isnan(g[5, :120]).all()
        keep = np.arange(300) != 5
        np.testing.assert_allclose(g[keep], r.numpy()[keep], rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("nu,box0", SHAPES, ids=["stock", "wide"])
@pytest.mark.parametrize("n_ns", [0, 1])
def test_woodbury_ns_cuda_matches_twin(cuda, nu, box0, n_ns):
    _, _, ins = _woodbury_inputs(3, 256, nu, box0)
    ins = {k: torch.as_tensor(v) for k, v in ins.items()}
    kw = dict(box0=box0, n_box=nu - box0, sigma=SIGMA, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
    before = kernels.woodbury_ns.launches
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()), **kw)
    torch.cuda.synchronize()
    assert kernels.woodbury_ns.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# every variant a wrapper can choose
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("p,nu,box0,variant",
                         [(P, 120, 96, "registers"),
                          (P2, NU2, BOX02, "cluster")])
def test_admm_segment_variants_cuda_match_twin(cuda, p, nu, box0, variant,
                                               batch):
    """K⁻¹ in registers at the stock size, in the strips of a cluster at
    twice the stock horizon (P = 256)."""
    assert kernels.segment_plan(batch, p)["route"] == variant
    ins = {k: torch.as_tensor(v) for k, v in
           _segment_inputs(2, batch, nu=nu, box0=box0, p=p).items()}
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5)
    ref = kernels.admm_segment_plain(*ins.values(), **kw)
    before = kernels.admm_segment.launches
    got = kernels.admm_segment(*(v.to(cuda) for v in ins.values()), **kw)
    torch.cuda.synchronize()
    assert kernels.admm_segment.launches == before + 1
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
def test_admm_segment_cuda_keeps_nan_in_its_lane(cuda):
    """A NaN in one scenario's state stays in that scenario (and stays NaN
    through the clip); its neighbours match the twin."""
    ins = {k: torch.as_tensor(v) for k, v in
           _segment_inputs(3, 4, nu=120, box0=96).items()}
    ins["x_f"][2, 5] = float("nan")
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=5)
    ref = kernels.admm_segment_plain(*ins.values(), **kw)
    got = kernels.admm_segment(*(v.to(cuda) for v in ins.values()), **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        g = g.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r.numpy()))
        assert np.isnan(g[2, :120]).all()
        keep = [0, 1, 3]
        np.testing.assert_allclose(g[keep], r.numpy()[keep], rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("n_ns", [0, 1])
def test_woodbury_ns_clusters_cuda_match_twin(cuda, n_ns, cluster, batch):
    """A scenario on one block and spread over a cluster of 8."""
    _, _, ins = _woodbury_inputs(5, batch, 120, 96)
    ins = {k: torch.as_tensor(v) for k, v in ins.items()}
    kw = dict(box0=96, n_box=24, sigma=SIGMA, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
    before = kernels.woodbury_ns.launches
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()),
                              cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert kernels.woodbury_ns.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("nu,box0", [(120, 0), (117, 91), (100, 63)],
                         ids=["wide", "ragged-small", "ragged-block"])
def test_woodbury_ns_cuda_other_boxes(cuda, nu, box0, cluster):
    """The wide box (n_box 120: the block-wide elimination) and boxes that
    start off a 16-byte boundary with a size that is no multiple of 4."""
    _, _, ins = _woodbury_inputs(6, 3, nu, box0)
    ins = {k: torch.as_tensor(v) for k, v in ins.items()}
    kw = dict(box0=box0, n_box=nu - box0, sigma=SIGMA, n_ns=2)
    ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()),
                              cluster=cluster, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


def _clamp_inputs(box0, nu=120, p=P):
    """A diagonal K⁻¹ and a ρ step that give the capacitance matrix an
    exactly zero pivot (index 3) and, after the elimination of pivot 7, a
    pivot of −2⁻⁴³ (index 8): both inside the clamp, on either side."""
    n = nu - box0
    rng = np.random.default_rng(5)
    x = np.zeros((1, p, p), np.float32)
    x[0, np.arange(nu), np.arange(nu)] = rng.uniform(0.5, 1.5, nu)
    d = np.zeros((1, p), np.float32)
    d[0, box0:nu] = rng.uniform(-0.3, 0.6, n)
    b = box0
    x[0, b + 3, b + 3], d[0, b + 3] = 2.0, -0.5          # M[3, 3] = 0
    x[0, b + 7, b + 7], d[0, b + 7] = 2.0, 0.5           # M[7, 7] = 2
    x[0, b + 7, b + 8] = 2.0 ** -10                      # M[7, 8] = 2⁻¹¹
    x[0, b + 8, b + 7] = -(2.0 ** -12) * (1 + 2.0 ** -19)
    x[0, b + 8, b + 8], d[0, b + 8] = 1 - 2.0 ** -24, -1.0   # M[8, 8] = 2⁻²⁴
    zero = np.zeros((1, p, p), np.float32)
    return [torch.as_tensor(v) for v in (x, zero, d, np.zeros_like(d))]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("nu,box0,n_ns", [(NU2, BOX02, 0), (NU2, BOX02, 1),
                                          (NU2, 120, 1), (237, 181, 2)],
                         ids=["polish", "refresh", "block", "ragged"])
def test_woodbury_ns_cuda_twice_the_stock_horizon(cuda, nu, box0, n_ns,
                                                  batch):
    """P = 256 (a cluster of 8 holds X and T): the box of 48 throttle knots,
    a box of 120 (the block-wide elimination) and a ragged one."""
    _, _, ins = _woodbury_inputs(7, batch, nu, box0, p=P2)
    ins = {k: torch.as_tensor(v) for k, v in ins.items()}
    kw = dict(box0=box0, n_box=nu - box0, sigma=SIGMA, n_ns=n_ns)
    assert kernels.woodbury_plan(batch, P2, nu - box0, n_ns)["cluster"] == 8
    ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
    before = kernels.woodbury_ns.launches
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()), **kw)
    torch.cuda.synchronize()
    assert kernels.woodbury_ns.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
def test_woodbury_ns_cuda_refuses_what_does_not_fit(cuda):
    """P = 384 and a box of 240 at P = 256 (refused before the general
    route) agree with the twin, and so does P = 1152 (refused before as
    above 1024); a padded size that is no multiple of 128 still raises, and
    nothing falls back to the twin."""
    for p, nu, box0 in ((384, 288, 264), (P2, NU2, 0), (1152, 1140, 1116)):
        _, _, ins = _woodbury_inputs(11, 2, nu, box0, p=p)
        ins = {k: torch.as_tensor(v) for k, v in ins.items()}
        kw = dict(box0=box0, n_box=nu - box0, sigma=SIGMA, n_ns=1)
        assert kernels.woodbury_plan(2, p, nu - box0, 1)["route"] == "general"
        ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
        got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()), **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5)
    before = kernels.woodbury_ns.launches
    m = torch.zeros(1, 1088, 1088, device=cuda)
    v = torch.zeros(1, 1088, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.woodbury_ns(m, m, v, v, box0=0, n_box=24, sigma=SIGMA, n_ns=1)
    assert kernels.woodbury_ns.launches == before


# (P, nU, box0, batch, n_ns): the general route at chip_smoke.py's shapes,
# P = 1152 (refused before as above 1024) with a box of 8 and of 132
GENERAL_SHAPES = [(P2, 132, 0, 1, 0), (P2, 132, 0, 64, 1), (384, 288, 208, 1, 1),
                  (640, 528, 520, 16, 1), (640, 528, 0, 1, 0)] + [
    (1152, 1140, box0, 1, n_ns) for box0 in (1132, 1008) for n_ns in (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("p,nu,box0,batch,n_ns", GENERAL_SHAPES)
def test_woodbury_ns_general_cuda_matches_twin(cuda, p, nu, box0, batch,
                                               n_ns):
    """The general route: a box wider than 128 at P = 256 (a control horizon
    of 13 with joint limits), P = 384 and P = 640, the elimination on one
    block (n_box 8) and on a cluster of 8 (528)."""
    _, _, ins = _woodbury_inputs(12, batch, nu, box0, p=p)
    ins = {k: torch.as_tensor(v) for k, v in ins.items()}
    kw = dict(box0=box0, n_box=nu - box0, sigma=SIGMA, n_ns=n_ns)
    assert kernels.woodbury_plan(batch, p, nu - box0, n_ns)["route"] == \
        "general"
    ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
    before = kernels.woodbury_ns.launches
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()), **kw)
    torch.cuda.synchronize()
    assert kernels.woodbury_ns.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, got.mT)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ns", [0, 1])
def test_woodbury_ns_general_cuda_spreads_a_lone_scenario(cuda, n_ns):
    """A lone scenario of the long horizon (P = 256, n_box 132) is spread
    over the card: every product and the symmetrisation launch more blocks
    than one, the elimination a cluster of them; the result is the twin's
    within 1e-5 and exactly symmetric, one wrapper launch."""
    plan = kernels.woodbury_plan(1, P2, 132, n_ns)
    assert plan["route"] == "general" and plan["kernels"] == 4 + 2 * n_ns
    assert plan["blocks"] > 1 and plan["cluster"] > 1
    assert all(s["blocks"] > 1 for s in plan["stages"])
    _, _, ins = _woodbury_inputs(21, 1, 132, 0, p=P2)
    ins = {k: torch.as_tensor(v) for k, v in ins.items()}
    kw = dict(box0=0, n_box=132, sigma=SIGMA, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins.values(), **kw)
    before = kernels.woodbury_ns.launches
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins.values()), **kw)
    torch.cuda.synchronize()
    assert kernels.woodbury_ns.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, got.mT)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ns", [0, 1])
def test_woodbury_ns_general_cuda_every_choice_matches_twin(cuda, n_ns):
    """Every tile edge, elimination cluster and place of M the general
    route's launcher takes, forced at ragged sizes (n_box 133 against 32-
    and 64-wide tiles, box0 = 123 off a 16-byte boundary, B = 2): each
    within 1e-5 of the twin and exactly symmetric."""
    p, nu, box0, batch = 384, 256, 123, 2
    _, _, ins = _woodbury_inputs(22, batch, nu, box0, p=p)
    ins = [torch.as_tensor(v) for v in ins.values()]
    kw = dict(box0=box0, n_box=nu - box0, sigma=SIGMA, n_ns=n_ns)
    ref = kernels.woodbury_ns_plain(*ins, **kw).numpy()
    ins = [v.to(cuda) for v in ins]
    lib = kernels._lib("woodbury_ns")
    for tile in kernels.WOODBURY_GENERAL_TILES:
        for c in kernels.WOODBURY_GJ_CLUSTERS:
            for in_smem in (True, False):
                plan = kernels.woodbury_general_plan(
                    batch, p, nu - box0, n_ns, tile=tile, gj_cluster=c,
                    gj_in_smem=in_smem)
                out = torch.empty_like(ins[0])
                rc = kernels._general_launch(
                    lib, [t.data_ptr() for t in ins + [out]], plan, batch, p,
                    box0, nu - box0, SIGMA, n_ns, cuda,
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                assert rc == 0, (tile, c, in_smem)
                np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=0,
                                           atol=1e-5)
                assert torch.equal(out, out.mT), (tile, c, in_smem)


@pytest.mark.gpu
def test_woodbury_ns_general_cuda_pivot_clamp(cuda):
    """The clamp of the general route's elimination, n_box 132 at P = 256."""
    ins = _clamp_inputs(0, nu=132, p=P2)
    kw = dict(box0=0, n_box=132, sigma=SIGMA, n_ns=0)
    ref = kernels.woodbury_ns_plain(*ins, **kw)
    assert ref[0, 3, 3] > 1e12 and ref[0, 8, 8] < -1e11
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins), **kw).cpu()
    assert torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().clamp_min(1.0)
    assert float(rel.max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("box0", [96, 0], ids=["small", "block"])
def test_woodbury_ns_cuda_pivot_clamp(cuda, box0, cluster):
    """|pivot| < 1e-12 is clamped to ∓1e-12 (+1e-12 for 0) by both
    eliminations, as the twin does: the results carry entries of ±1e12 and
    agree to float32 rounding."""
    ins = _clamp_inputs(box0)
    kw = dict(box0=box0, n_box=120 - box0, sigma=SIGMA, n_ns=0)
    ref = kernels.woodbury_ns_plain(*ins, **kw)
    assert torch.isfinite(ref).all()
    assert ref[0, box0 + 3, box0 + 3] > 1e12      # 0 -> +1e-12
    assert ref[0, box0 + 8, box0 + 8] < -1e11     # -2^-43 -> -1e-12
    got = kernels.woodbury_ns(*(v.to(cuda) for v in ins), cluster=cluster,
                              **kw).cpu()
    assert torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().clamp_min(1.0)
    assert float(rel.max()) < 1e-5


@pytest.mark.gpu
def test_woodbury_smem_bytes_matches_the_built_kernel(cuda):
    """The Python layout equals make_layout of the compiled source."""
    lib = kernels._lib("woodbury_ns")
    fn = lib.woodbury_ns_smem_bytes
    for p, clusters in kernels.WOODBURY_CLUSTERS.items():
        for n_box in (1, 7, 24, 32, 33, 48, 100, 120, 128):
            for n_ns in (0, 1, 2):
                for c in clusters:
                    assert fn(p, n_box, n_ns, c) == \
                        kernels.woodbury_smem_bytes(n_box, n_ns, c, p), \
                        (p, n_box, n_ns, c)
    for tile in kernels.WOODBURY_GENERAL_TILES:
        assert lib.woodbury_ns_general_product_smem_bytes(tile) == \
            kernels.woodbury_general_product_smem_bytes(tile)
    for n_box in (1, 8, 80, 132, 231, 232, 528, 1024):
        for c in kernels.WOODBURY_GJ_CLUSTERS:
            for in_smem in (0, 1):
                assert lib.woodbury_ns_general_gj_smem_bytes(
                    n_box, c, in_smem) == \
                    kernels.woodbury_general_gj_smem_bytes(n_box, c, in_smem)
        for n_ns in (0, 1):
            assert lib.woodbury_ns_general_scratch_floats(
                1024, n_box, n_ns) == \
                kernels.woodbury_general_scratch_floats(1024, n_box, n_ns)


def _solve_twice(dev, batch=3, nu=NU2, box0=BOX02):
    """A cold and a warm condensed solve of a seeded box QP at twice the
    stock horizon; the warm one refreshes the carried inverse."""
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import condensed

    rng = np.random.default_rng(8)
    nb = nu - box0
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa
    qp = condensed.CondensedQP(
        H=t(_spd(rng, batch, nu)), q=t(rng.normal(size=(batch, nu))),
        lb=t(-0.05 - 0.1 * np.abs(rng.normal(size=(batch, nb)))),
        ub=t(0.05 + 0.1 * np.abs(rng.normal(size=(batch, nb)))),
        F=t(rng.normal(size=(batch, 2, 26, nu))),
        f=t(rng.normal(size=(batch, 2, 26))))
    settings = admm.ADMMSettings(max_iter=40, polish=True,
                                 rho_update_iters=(15,), term_check_every=5,
                                 kernel_mode="auto")
    cold = condensed.solve(None, qp, settings)
    qp2 = qp._replace(q=qp.q + 0.05 * t(rng.normal(size=(batch, nu))))
    _, _, scaling = condensed.equilibrate(qp.H, qp.q, box0,
                                          settings.scaling_iters)
    warm = condensed.solve(None, qp2, settings, warm_u=cold.u, warm_y=cold.y,
                           scaling=scaling, kinv_prev=cold.kinv,
                           rho_prev=cold.rho_vec,
                           rho_scalar_prev=cold.rho_scalar)
    return cold, warm


@pytest.mark.gpu
def test_solve_on_card_with_a_box_wider_than_128(cuda):
    """nU = 132 with every input boxed (a control horizon of 13 with joint
    limits) pads to P = 256: the refresh takes the general route, and the
    solve agrees with its own CPU run."""
    before = kernels.woodbury_ns.launches
    got = _solve_twice(cuda, nu=132, box0=0)
    torch.cuda.synchronize()
    assert kernels.woodbury_ns.launches > before
    ref = _solve_twice(torch.device("cpu"), nu=132, box0=0)
    for g, r in zip(got, ref):
        assert torch.equal(g.status.cpu(), r.status)
        np.testing.assert_allclose(g.u.cpu().numpy(), r.u.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
def test_solve_on_card_at_twice_the_stock_horizon(cuda):
    """nU = 240 pads to P = 256: the solve launches both tick kernels there
    and agrees with its own CPU run (the plain twins)."""
    before = (kernels.admm_segment.launches, kernels.woodbury_ns.launches)
    got = _solve_twice(cuda)
    torch.cuda.synchronize()
    assert kernels.admm_segment.launches > before[0]
    assert kernels.woodbury_ns.launches > before[1]
    ref = _solve_twice(torch.device("cpu"))
    for g, r in zip(got, ref):
        assert torch.equal(g.status.cpu(), r.status)
        np.testing.assert_allclose(g.u.cpu().numpy(), r.u.numpy(), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g.states.cpu().numpy(), r.states.numpy(),
                                   rtol=0, atol=2e-3)
