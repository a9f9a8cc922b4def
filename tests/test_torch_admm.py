"""The port's full-space OSQP solver (``ironcub_mpc_tpu_torch.ops.admm``)
against the JAX package's, case for case of tests/test_admm.py.

Each case builds its QP with numpy from a seed, solves it with the JAX
function (``jax.vmap`` where the case is batched) and with the port's on the
same float32 inputs with a leading lane dimension, and compares x, y,
status and iterations; the closed-form or enumerated oracle of
tests/test_admm.py holds the port as it holds JAX. Two cases are the port's
own: lanes whose scales differ by 10³ (a reduction over the batch in place
of a lane's own axes would show), and a NaN warm start.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu_torch.ops import admm as tadmm

from test_admm import _solve_np_active_set
from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JSET = jadmm.ADMMSettings(max_iter=400)
TSET = tadmm.ADMMSettings(max_iter=400)


def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


def _port(*arrays, batched=False):
    """numpy -> CPU tensors with a lane dimension."""
    return [torch.as_tensor(a) if batched else torch.as_tensor(a)[None]
            for a in arrays]


def _agree(jsol, tsol, tol, lanes=None):
    """x, y, status and iterations of the port against JAX. x and y are
    compared as a max error normalised by JAX's largest magnitude (at
    least 1): the same float32 iteration, summed in other orders."""
    jx, jy = np.asarray(jsol.x), np.asarray(jsol.y)
    if lanes is None:
        jx, jy = jx[None], jy[None]
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status).reshape(-1))
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations).reshape(-1))
    for name, got, want in (("x", tsol.x.numpy(), jx),
                            ("y", tsol.y.numpy(), jy)):
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
        assert err < tol, f"{name}: normalized max err {err:.3e} >= {tol}"


def _random_qp(seed, n, m, bounds="box"):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    if bounds == "unit":
        return _f32(P, q, A, -np.ones(m), np.ones(m))
    return _f32(P, q, A, -np.abs(rng.normal(size=m)),
                np.abs(rng.normal(size=m)))


def test_separable_box_qp():
    diag = np.array([1.0, 2.0, 4.0, 0.5], np.float32)
    qp = _f32(np.diag(diag), [1.0, -4.0, 0.5, 2.0], np.eye(4), -np.ones(4),
              np.ones(4))
    jsol = jadmm.solve(*(jnp.asarray(a) for a in qp), JSET)
    tsol = tadmm.solve(*_port(*qp), TSET)
    _agree(jsol, tsol, 1e-5)
    expected = np.clip(-qp[1] / diag, -1.0, 1.0)
    np.testing.assert_allclose(tsol.x[0].numpy(), expected, atol=2e-3)
    assert int(tsol.status[0]) in (tadmm.SOLVED, tadmm.SOLVED_INACCURATE)


def test_equality_constrained_matches_kkt():
    rng = np.random.default_rng(1)
    n, m = 8, 3
    M = rng.normal(size=(n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    K = np.block([[P, A.T], [A, np.zeros((m, m))]])
    xe = np.linalg.solve(K, np.concatenate([-q, b]))[:n]
    qp = _f32(P, q, A, b, b)
    jsol = jadmm.solve(*(jnp.asarray(a) for a in qp), JSET)
    tsol = tadmm.solve(*_port(*qp), TSET)
    _agree(jsol, tsol, 1e-4)
    np.testing.assert_allclose(tsol.x[0].numpy(), xe, atol=5e-3, rtol=1e-3)
    assert int(tsol.status[0]) in (tadmm.SOLVED, tadmm.SOLVED_INACCURATE)


def test_general_qp_matches_active_set_enumeration():
    rng = np.random.default_rng(2)
    n, m = 5, 4
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l = -np.abs(rng.normal(size=m)) * 0.2
    u = np.abs(rng.normal(size=m)) * 0.2
    x_ref = _solve_np_active_set(P, q, A, l, u)
    assert x_ref is not None
    qp = _f32(P, q, A, l, u)
    jsol = jadmm.solve(*(jnp.asarray(a) for a in qp), JSET)
    tsol = tadmm.solve(*_port(*qp), TSET)
    _agree(jsol, tsol, 1e-4)
    np.testing.assert_allclose(tsol.x[0].numpy(), x_ref, atol=5e-3, rtol=1e-2)


def test_kkt_optimality_of_mpc_scale_problem():
    """The 120 × 90 QP with 40 equality rows: KKT residuals directly."""
    rng = np.random.default_rng(3)
    n, m = 120, 90
    M = rng.normal(size=(n, n)) * 0.1
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n)) * 0.5
    l = np.where(np.arange(m) < 40, rng.normal(size=m) * 0.1, -1.0)
    u = np.where(np.arange(m) < 40, l, 1.0)
    qp = _f32(P, q, A, l, u)
    jsol = jax.jit(lambda *a: jadmm.solve(
        *a, jadmm.ADMMSettings(max_iter=600)))(*(jnp.asarray(a) for a in qp))
    tsol = tadmm.solve(*_port(*qp), tadmm.ADMMSettings(max_iter=600))
    _agree(jsol, tsol, 1e-4)
    x, y = tsol.x[0].numpy(), tsol.y[0].numpy()
    assert np.max(np.abs(P @ x + q + A.T @ y)) < 5e-2
    Ax = A @ x
    assert np.all(Ax > l - 1e-2) and np.all(Ax < u + 1e-2)
    assert int(tsol.status[0]) in (tadmm.SOLVED, tadmm.SOLVED_INACCURATE)


def test_primal_infeasible_detection():
    # x0 >= 1 and x0 <= -1 simultaneously: infeasible
    qp = _f32(np.eye(2), np.zeros(2), [[1.0, 0.0], [1.0, 0.0]],
              [1.0, -1e20], [1e20, -1.0])
    jsol = jadmm.solve(*(jnp.asarray(a) for a in qp),
                       jadmm.ADMMSettings(max_iter=400, polish=False))
    tsol = tadmm.solve(*_port(*qp),
                       tadmm.ADMMSettings(max_iter=400, polish=False))
    assert int(jsol.status) == int(tsol.status[0]) == tadmm.PRIMAL_INFEASIBLE


def _lanes(seed, B, n, m):
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(B, n, n))
    return _f32(np.einsum("bij,bkj->bik", Ms, Ms) + np.eye(n),
                rng.normal(size=(B, n)), rng.normal(size=(B, m, n)),
                -np.abs(rng.normal(size=(B, m))),
                np.abs(rng.normal(size=(B, m))))


def test_batched_vmap_solves():
    """Eight lanes at once: the port's batch against JAX's vmap, lane for
    lane, and each lane against active-set enumeration."""
    qp = _lanes(4, 8, 6, 5)
    jsol = jax.jit(jax.vmap(lambda *a: jadmm.solve(*a, JSET)))(
        *(jnp.asarray(a) for a in qp))
    tsol = tadmm.solve(*_port(*qp, batched=True), TSET)
    assert tsol.x.shape == (8, 6)
    _agree(jsol, tsol, 1e-4, lanes=8)
    for b in range(8):
        x_ref = _solve_np_active_set(*(a[b].astype(np.float64) for a in qp))
        if x_ref is not None:
            np.testing.assert_allclose(tsol.x[b].numpy(), x_ref, atol=1e-2,
                                       rtol=5e-2)


def test_lanes_of_different_scale_solve_as_alone():
    """Lanes whose data differ in scale by 10³ (P, q, bounds): each lane of
    the batch equals the same lane solved alone, and JAX's vmap. Ruiz's
    mean column norm, the residual maxima, the certificates and the polish
    acceptance must reduce over a lane's own axes only."""
    P, q, A, l, u = _lanes(7, 4, 6, 5)
    s = np.array([1e-3, 1.0, 1e3, 1.0], np.float32)
    qp = [P * s[:, None, None], q * s[:, None], A, l * s[:, None],
          u * s[:, None]]
    tsol = tadmm.solve(*_port(*qp, batched=True), TSET)
    jsol = jax.jit(jax.vmap(lambda *a: jadmm.solve(*a, JSET)))(
        *(jnp.asarray(a) for a in qp))
    _agree(jsol, tsol, 1e-4, lanes=4)
    for b in range(4):
        alone = tadmm.solve(*_port(*(a[b] for a in qp)), TSET)
        for name in tadmm.QPSolution._fields:
            np.testing.assert_allclose(
                getattr(tsol, name)[b].numpy(), getattr(alone, name)[0].numpy(),
                rtol=1e-5, atol=1e-6 * float(s[b]), err_msg=f"lane {b} {name}")


def test_warm_start_reduces_iterations():
    qp = _random_qp(5, 20, 15)
    s_j = jadmm.ADMMSettings(max_iter=1000, polish=False)
    s_t = tadmm.ADMMSettings(max_iter=1000, polish=False)
    ja = [jnp.asarray(a) for a in qp]
    cold_j = jadmm.solve_adaptive(*ja, s_j, check_every=10)
    warm_j = jadmm.solve_adaptive(*ja, s_j, x0=cold_j.x, y0=cold_j.y,
                                  check_every=10)
    ta = _port(*qp)
    cold = tadmm.solve_adaptive(*ta, s_t, check_every=10)
    warm = tadmm.solve_adaptive(*ta, s_t, x0=cold.x, y0=cold.y,
                                check_every=10)
    _agree(cold_j, cold, 1e-4)
    _agree(warm_j, warm, 1e-4)
    assert int(warm.iterations[0]) <= int(cold.iterations[0])
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), atol=5e-3)


def test_adaptive_lanes_stop_on_their_own():
    """solve_adaptive over a batch: a lane that converges keeps its state
    and its iteration count while the others run on (JAX's while_loop under
    vmap)."""
    qp = _lanes(8, 3, 10, 8)
    s_j = jadmm.ADMMSettings(max_iter=1000, polish=False)
    s_t = tadmm.ADMMSettings(max_iter=1000, polish=False)
    # a warm start at the solution for lane 1 only: it stops at the first
    # check while lanes 0 and 2 start cold
    first = tadmm.solve_adaptive(*_port(*qp, batched=True), s_t,
                                 check_every=10)
    x0 = torch.zeros_like(first.x)
    y0 = torch.zeros_like(first.y)
    x0[1], y0[1] = first.x[1], first.y[1]
    tsol = tadmm.solve_adaptive(*_port(*qp, batched=True), s_t, x0=x0, y0=y0,
                                check_every=10)
    jsol = jax.jit(jax.vmap(lambda P, q, A, l, u, x0, y0: jadmm.solve_adaptive(
        P, q, A, l, u, s_j, x0=x0, y0=y0, check_every=10)))(
            *(jnp.asarray(a) for a in qp), jnp.asarray(x0.numpy()),
            jnp.asarray(y0.numpy()))
    _agree(jsol, tsol, 1e-4, lanes=3)
    it = tsol.iterations.numpy()
    assert it[1] == 10 and it[0] > 10 and it[2] > 10, it


def test_nan_warm_start_is_sanitised():
    """A warm start carried from a failed solve: non-finite entries start
    from zero, so the solve equals the cold one, on both sides."""
    qp = _random_qp(9, 12, 9)
    nan_x = np.full((1, 12), np.nan, np.float32)
    nan_y = np.full((1, 9), np.nan, np.float32)
    nan_x[0, :4] = 0.0
    tsol = tadmm.solve(*_port(*qp), TSET, x0=torch.as_tensor(nan_x),
                       y0=torch.as_tensor(nan_y))
    cold = tadmm.solve(*_port(*qp), TSET)
    jsol = jadmm.solve(*(jnp.asarray(a) for a in qp), JSET,
                       x0=jnp.asarray(nan_x[0]), y0=jnp.asarray(nan_y[0]))
    _agree(jsol, tsol, 1e-4)
    for name in ("x", "y", "status"):
        np.testing.assert_array_equal(getattr(tsol, name).numpy(),
                                      getattr(cold, name).numpy())


def test_scaling_reuse():
    """prepare() with a precomputed scaling equals a fresh scaling, and the
    per-lane scaling matches JAX's Ruiz equilibration."""
    qp = _random_qp(6, 6, 4, bounds="unit")
    ta = _port(*qp)
    data1 = tadmm.prepare(*ta, TSET)
    data2 = tadmm.prepare(*ta, TSET, scaling=data1.scaling)
    jdata = jadmm.prepare(*(jnp.asarray(a) for a in qp), JSET)
    for name in ("d", "e", "c"):
        np.testing.assert_allclose(getattr(data1.scaling, name)[0].numpy(),
                                   np.asarray(getattr(jdata.scaling, name)),
                                   rtol=1e-6)
    np.testing.assert_allclose(data1.P.numpy(), data2.P.numpy(), rtol=1e-5)
    np.testing.assert_allclose(data1.l.numpy(), data2.l.numpy(), rtol=1e-5)
    sol1 = tadmm.solve_prepared(data1, TSET)
    sol2 = tadmm.solve_prepared(data2, TSET)
    np.testing.assert_allclose(sol1.x.numpy(), sol2.x.numpy(), atol=1e-4)
    _agree(jadmm.solve_prepared(jdata, JSET), sol1, 1e-4)


def test_failed_factorisation_gives_nan_not_an_error():
    """K that is not positive definite: the lane's Cholesky factor is NaN,
    as XLA's, and nothing raises; the other lane is untouched."""
    P = np.stack([np.eye(3), -np.eye(3)]).astype(np.float32)
    A = np.zeros((2, 1, 3), np.float32)
    rho = torch.full((2, 1), 0.1)
    L = tadmm.factorize(torch.as_tensor(P), torch.as_tensor(A), rho, 1e-6)
    want = np.asarray(jax.vmap(jnp.linalg.cholesky)(jnp.asarray(P)))
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(want))
    assert np.isnan(want[1]).any() and np.isfinite(want[0]).all()
    np.testing.assert_allclose(L[0].numpy(), want[0], rtol=1e-6)


@pytest.mark.parametrize("with_nan", [False, True])
def test_polish_keeps_iterate_unless_better(with_nan):
    """polish falls back to the ADMM iterate where its candidate does not
    lower the residuals (a NaN candidate never does)."""
    qp = _random_qp(10, 6, 4)
    data = tadmm.prepare(*_port(*qp), TSET)
    sol = tadmm.solve_prepared(data, tadmm.ADMMSettings(max_iter=400,
                                                        polish=False))
    d, e, c = data.scaling
    x, y = sol.x / d, sol.y * c[:, None] / e
    z = sol.z * e
    if with_nan:
        data = data._replace(P=torch.full_like(data.P, float("nan")))
    xp, zp, yp = tadmm.polish(data, TSET, x, z, y)
    if with_nan:
        assert torch.equal(xp, x) and torch.equal(yp, y)
    else:
        p0, d0, _, _ = tadmm._residuals(data, x, z, y)
        p1, d1, _, _ = tadmm._residuals(data, xp, zp, yp)
        assert float(p1 + d1) <= float(p0 + d0)
