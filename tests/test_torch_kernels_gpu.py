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


def _pad_mat(A):
    return np.pad(A, ((0, 0), (0, P - A.shape[-1]), (0, P - A.shape[-1])))


def _full(v_box, nu, box0, fill=0.0):
    out = np.full((v_box.shape[0], P), fill, np.float32)
    out[:, nu:] = 0.0
    out[:, box0:nu] = v_box
    return out


def _segment_inputs(seed, batch, nu=NU, box0=BOX0):
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
        Kinv_p=_pad_mat(Kinv), q_f=np.pad(q, ((0, 0), (0, P - nu))),
        lb_f=_full(lb, nu, box0, -BIG), ub_f=_full(ub, nu, box0, BIG),
        rho_f=_full(rho, nu, box0), rhoi_f=_full(1.0 / rho, nu, box0),
        x_f=np.pad(x0, ((0, 0), (0, P - nu))), z_f=_full(z0, nu, box0),
        y_f=_full(y0, nu, box0))


def _woodbury_inputs(seed, batch, nu, box0):
    nb = nu - box0
    rng = np.random.default_rng(seed)
    H = _spd(rng, batch, nu)
    rho_old = (np.abs(rng.normal(size=(batch, nb))) + 0.1).astype(np.float32)
    rho_new = (rho_old * rng.uniform(0.2, 5.0, (batch, nb))).astype(
        np.float32)
    Kinv = _kinv(H, np.pad(rho_old, ((0, 0), (box0, 0))))
    return H, rho_new, dict(
        Kinv_p=_pad_mat(Kinv), H_p=_pad_mat(H),
        d_f=_full(rho_new - rho_old, nu, box0), rho_f=_full(rho_new, nu, box0))


# (nu, box0): the stock condensed layout (24 throttle knots at 96) and the
# joint-limits layout (the box covers all 120 inputs)
SHAPES = [(120, 96), (120, 0)]


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
                         [(512, 40, 8), (256, 5, 8), (16, 7, 4), (6, 3, 2),
                          (5, 3, 1)])
def test_admm_segment_grouped_cuda_matches_twin_and_single(cuda, batch,
                                                           length, group):
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
        # the same summation order as the single-scenario kernel
        np.testing.assert_allclose(g.cpu().numpy(), s.cpu().numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.gpu
def test_admm_segment_grouped_cuda_refuses_what_does_not_fit(cuda):
    """A group that does not fit one thread block raises; nothing falls back
    to another kernel or to the twin."""
    ins = [torch.as_tensor(v).to(cuda) for v in
           _segment_inputs(4, 32, nu=120, box0=96).values()]
    before = kernels.admm_segment_grouped.launches
    with pytest.raises(ValueError, match="does not fit one thread block"):
        kernels.admm_segment_grouped(*ins, sigma=SIGMA, alpha=ALPHA, length=2,
                                     group=16)
    with pytest.raises(ValueError, match="not divisible"):
        kernels.admm_segment_grouped(*ins, sigma=SIGMA, alpha=ALPHA, length=2,
                                     group=5)
    assert kernels.admm_segment_grouped.launches == before


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
