"""The port's kernels' plain twins against the Pallas kernels they replace.

On the CPU each wrapper in ``ironcub_mpc_tpu_torch.ops.kernels`` runs its
plain PyTorch twin; that twin is held against ``pallas_solve.admm_segment``,
``pallas_solve.admm_segment_grouped`` and ``pallas_solve.woodbury_ns`` run
as tests/test_pallas_solve.py runs them (interpret mode, jitted, vmapped), at the shapes and tolerances of
that file. The CUDA kernels themselves are held against the twins on a
card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

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
