"""The port's SO(3)/RPY algebra and jet model against the JAX package.

Inputs are drawn from a seed with numpy and fed to both implementations;
the jet model's hand partials are also checked against ``torch.func``
autograd, as tests/test_jet_model.py checks the JAX ones with ``jax.grad``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.ops import jet_model as jjm
from ironcub_mpc_tpu.ops import so3 as jso3

from ironcub_mpc_tpu_torch.ops import jet_model as tjm
from ironcub_mpc_tpu_torch.ops import so3 as tso3

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32 elementwise maths on both sides; differences are last-bit rounding
# of sin/cos/atan2 between XLA's and PyTorch's CPU kernels
ATOL = 2e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _rotations(n, seed=0):
    rpy = _rng(seed).uniform([-2.5, -1.2, -3.1], [2.5, 1.2, 3.1],
                             size=(n, 3)).astype(np.float32)
    return np.array(jso3.rpy_to_matrix(jnp.asarray(rpy))), rpy


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(torch.as_tensor(a) for a in arrays))
    return out_j, out_t


def _close(out_j, out_t, atol=ATOL, rtol=0.0):
    if isinstance(out_j, tuple):
        for a, b in zip(out_j, out_t):
            _close(a, b, atol, rtol)
        return
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=atol, rtol=rtol)


def test_skew_and_inv3_match():
    rng = _rng(1)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    _close(*_both(jso3.skew, tso3.skew, v), atol=0.0)
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32))
    # adjugate / determinant in float32 on both sides
    _close(*_both(jso3.inv3, tso3.inv3, M), atol=0.0, rtol=1e-5)


def test_matrix_to_rpy_and_euler_rate_maps_match():
    R, rpy = _rotations(32)
    _close(*_both(jso3.matrix_to_rpy, tso3.matrix_to_rpy, R))
    _close(*_both(jso3.euler_rate_matrix, tso3.euler_rate_matrix, rpy))
    # W⁻¹ holds 1/cos(pitch): up to ~3 at |pitch| <= 1.2, so relative
    _close(*_both(jso3.euler_rate_matrix_inv, tso3.euler_rate_matrix_inv,
                  rpy), rtol=2e-6)
    W = tso3.euler_rate_matrix(torch.as_tensor(rpy))
    Wi = tso3.euler_rate_matrix_inv(torch.as_tensor(rpy))
    np.testing.assert_allclose((W @ Wi).numpy(),
                               np.broadcast_to(np.eye(3), (32, 3, 3)),
                               atol=1e-5)


def test_unwrap_rpy_matches_and_keeps_int32():
    rng = _rng(2)
    old = rng.uniform(-np.pi, np.pi, size=(64, 3)).astype(np.float32)
    # every case: no wrap, wrap up, wrap down
    jump = rng.choice([0.0, 2 * np.pi - 0.1, -(2 * np.pi - 0.1)],
                      size=(64, 3))
    new = (old + jump + rng.normal(0, 0.01, size=(64, 3))).astype(np.float32)
    turns = rng.integers(-2, 3, size=(64, 3)).astype(np.int32)
    out_j = jso3.unwrap_rpy(jnp.asarray(new), jnp.asarray(old),
                            jnp.asarray(turns))
    out_t = tso3.unwrap_rpy(torch.as_tensor(new), torch.as_tensor(old),
                            torch.as_tensor(turns))
    assert out_t[1].dtype == torch.int32
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    _close(out_j[0], out_t[0], atol=0.0)


POLY = ["f", "g", "df_dt", "df_dtd", "dg_dt", "dg_dtd", "f_newton",
        "g_newton"]
ONE_ARG = ["v", "standardize_thrust", "standardize_thrust_dot",
           "standardize_throttle", "destandardize_thrust",
           "destandardize_thrust_dot", "destandardize_throttle",
           "throttle_to_v"]


@pytest.mark.parametrize("name", POLY)
def test_jet_polynomials_match(name):
    rng = _rng(3)
    t = rng.normal(size=64).astype(np.float32)
    td = rng.normal(size=64).astype(np.float32)
    if name.endswith("newton"):             # physical units [N], [N/s]
        t = (100.0 + 60.0 * t).astype(np.float32)
        td = (30.0 * td).astype(np.float32)
    out_j, out_t = _both(getattr(jjm, name), getattr(tjm, name), t, td)
    _close(out_j, out_t, atol=0.0, rtol=2e-6)


@pytest.mark.parametrize("name", ONE_ARG)
def test_jet_standardisation_matches(name):
    x = np.linspace(-150.0, 250.0, 81).astype(np.float32)
    _close(*_both(getattr(jjm, name), getattr(tjm, name), x), atol=0.0,
           rtol=2e-6)


def test_jet_rate_partials_match():
    rng = _rng(4)
    T = rng.uniform(10.0, 220.0, 32).astype(np.float32)
    Td = rng.uniform(-30.0, 30.0, 32).astype(np.float32)
    u = rng.uniform(10.0, 95.0, 32).astype(np.float32)
    for name in ("dh_dthrust", "dh_dthrust_dot", "thrust_ddot"):
        _close(*_both(getattr(jjm, name), getattr(tjm, name), T, Td, u),
               atol=0.0, rtol=2e-5)


def test_hand_partials_match_autograd():
    """As tests/test_jet_model.py with jax.grad: the hand partials of the
    standardized polynomials and of the Newton-space rate h against
    torch.func autograd."""
    from torch.func import grad, vmap

    pts = _rng(0).normal(size=(16, 2)).astype(np.float32)
    t, td = torch.as_tensor(pts[:, 0]), torch.as_tensor(pts[:, 1])
    for fn, dt_name, dtd_name in ((tjm.f, "df_dt", "df_dtd"),
                                  (tjm.g, "dg_dt", "dg_dtd")):
        np.testing.assert_allclose(getattr(tjm, dt_name)(t, td),
                                   vmap(grad(fn, 0))(t, td), rtol=1e-4)
        np.testing.assert_allclose(getattr(tjm, dtd_name)(t, td),
                                   vmap(grad(fn, 1))(t, td), rtol=1e-4)
    T = torch.tensor([10.0, 100.0, 220.0])
    Td = torch.tensor([0.0, 30.0, -10.0])
    u = torch.tensor([20.0, 60.0, 95.0])
    h = tjm.thrust_ddot
    np.testing.assert_allclose(tjm.dh_dthrust(T, Td, u),
                               vmap(grad(h, 0))(T, Td, u), rtol=1e-3)
    np.testing.assert_allclose(tjm.dh_dthrust_dot(T, Td, u),
                               vmap(grad(h, 1))(T, Td, u), rtol=1e-3)
    jax_g0 = jax.vmap(jax.grad(jjm.thrust_ddot, 0))(
        jnp.asarray(T.numpy()), jnp.asarray(Td.numpy()),
        jnp.asarray(u.numpy()))
    np.testing.assert_allclose(vmap(grad(h, 0))(T, Td, u), jax_g0,
                               rtol=1e-4)


def test_throttle_roundtrip_and_clamps():
    u = torch.linspace(0.0, 100.0, 21)
    np.testing.assert_allclose(tjm.destandardize_throttle(
        tjm.throttle_to_v(u)), u, atol=1e-3)
    assert float(tjm.destandardize_throttle(
        tjm.throttle_to_v(torch.tensor(-50.0)))) == 0.0
    assert float(tjm.destandardize_throttle(
        tjm.throttle_to_v(torch.tensor(150.0)))) == 100.0
