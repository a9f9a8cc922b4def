"""The port's row-sharded ADMM (``parallel/tp_admm.py``) against the JAX
package's ``solve_tp`` and against the port's single-device solver.

The cases mirror ``tests/test_parallel.py::test_tp_admm_matches_single_device``
(24 variables, 18 rows) and ``test_tp_admm_row_padding`` (10 variables,
5 rows: over a kkt axis of 2, one 0 ≤ 0 ≤ 0 pad row), 300 iterations, no
polish. The port runs them over two ``gloo`` processes on the CPU (a
``(1, 2)`` mesh, one spawn for every case), JAX on its virtual
``make_mesh(n_scenario=4, n_kkt=2)``.

Tolerances:
- against the port's ``ops/admm.solve`` (adaptive ρ, its own iteration
  count): JAX's own ``atol=5e-3, rtol=1e-2`` between its ``solve_tp`` and
  ``admm.solve``;
- against JAX's ``solve_tp`` on kkt 2, and the port's kkt 2 against its
  kkt 1: ``psum(AᵀρA)`` and ``psum(Aᵀv)`` sum over the shards in another
  order than one product, so the iterates agree to rounding, not bit for
  bit. Measured over both cases, of each field's largest entry: the port's
  kkt 2 against JAX's kkt 2 up to 1.7e-6 (z; x 6.3e-7), against the port's
  kkt 1 up to 4.9e-7; JAX's own kkt 2 against its kkt 1 up to 5.4e-7
  (``-s`` prints them). Held at 1e-5, for x, y and z.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.parallel import make_mesh as jmake_mesh
from ironcub_mpc_tpu.parallel.tp_admm import solve_tp as jsolve_tp

from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.parallel.tp_admm import pad_rows, solve_tp

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KKT = 2
MAX_ITER = 300
TOL_ROUNDING = 1e-5


def _case(name):
    """The QPs of tests/test_parallel.py's two solve_tp tests."""
    if name == "single_device":
        rng = np.random.default_rng(0)
        n, m = 24, 18
        M = rng.normal(size=(n, n))
        P = M @ M.T + np.eye(n)
        q = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        l = -np.abs(rng.normal(size=m)) - 0.05
        u = np.abs(rng.normal(size=m)) + 0.05
    else:
        rng = np.random.default_rng(1)
        n, m = 10, 5
        M = rng.normal(size=(n, n))
        P = M @ M.T + np.eye(n)
        q = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        l, u = -np.ones(m), np.ones(m)
    return [np.asarray(a, np.float32) for a in (P, q, A, l, u)]


CASES = ("single_device", "row_padding")


def _port(case, mesh=None, settings=None):
    """The port's solve_tp of one case as one lane."""
    P, q, A, l, u = (torch.as_tensor(a) for a in _case(case))
    settings = settings or tadmm.ADMMSettings(max_iter=MAX_ITER,
                                              polish=False)
    return solve_tp(P, q[None], A, l[None], u[None], mesh, settings)


def _rank(rank, port, out):
    """One rank of the (1, 2) mesh: every case, the solutions to ``out``."""
    import torch.distributed as dist

    from ironcub_mpc_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=KKT, rank=rank)
    try:
        mesh = make_mesh(n_scenario=1, n_kkt=KKT, device="cpu")
        assert (mesh.kkt_index, mesh.scenario_index) == (rank, 0)
        torch.save({c: _port(c, mesh)._asdict() for c in CASES}, out)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The port's kkt-2 solutions of every case, from each of the two
    ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(KKT)]
    procs = [ctx.Process(target=_rank, args=(r, port, str(outs[r])))
             for r in range(KKT)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        alive = p.is_alive()
        if alive:
            p.kill()
        assert not alive and p.exitcode == 0, p.exitcode
    return [torch.load(o, weights_only=True) for o in outs]


def _jax(case, n_kkt):
    """JAX's solve_tp on a (devices / n_kkt, n_kkt) mesh, under jit (one
    compile; called eagerly, its shard_map takes tens of seconds a call on
    the CPU)."""
    mesh = jmake_mesh(n_scenario=len(jax.devices()) // n_kkt, n_kkt=n_kkt)
    settings = jadmm.ADMMSettings(max_iter=MAX_ITER, polish=False)
    return jax.jit(lambda *qp: jsolve_tp(*qp, mesh, settings))(
        *map(jnp.asarray, _case(case)))


def _spread(a, b):
    """Largest difference over the largest entry of ``b`` (at least 1)."""
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("case", CASES)
def test_tp_admm_matches_single_device(sharded, case):
    """kkt 2 over two ranks: x, y, z replicated on both ranks; against
    JAX's kkt 2 and the port's kkt 1 to rounding; against the port's
    single-device solver at JAX's tolerance; SOLVED."""
    rank0, rank1 = (r[case] for r in sharded)
    for k in rank0:
        assert torch.equal(rank0[k], rank1[k]), k
    m = _case(case)[2].shape[0]
    x = rank0["x"][0].numpy()
    assert rank0["y"].shape == rank0["z"].shape == (1, m)
    assert int(rank0["iterations"]) == MAX_ITER
    assert int(rank0["status"]) == tadmm.SOLVED

    jax2, jax1 = _jax(case, KKT), _jax(case, 1)
    one = _port(case)
    assert int(jax2.status) == int(rank0["status"])
    for f in ("x", "y", "z"):
        got = rank0[f][0].numpy()
        spreads = (_spread(got, getattr(jax2, f)),
                   _spread(got, getattr(one, f)[0]),
                   _spread(getattr(jax2, f), getattr(jax1, f)))
        print(f"\n{case} {f}: port kkt 2 against JAX kkt 2 "
              f"{spreads[0]:.2e}, against port kkt 1 {spreads[1]:.2e}; JAX "
              f"kkt 2 against JAX kkt 1 {spreads[2]:.2e}")
        assert max(spreads[:2]) < TOL_ROUNDING, (f, spreads)
    np.testing.assert_allclose(float(rank0["pri_res"]), float(jax2.pri_res),
                               rtol=0.1, atol=1e-6)

    P, q, A, l, u = (torch.as_tensor(a) for a in _case(case))
    ref = tadmm.solve(P, q[None], A, l[None], u[None],
                      tadmm.ADMMSettings(max_iter=MAX_ITER, polish=False))
    np.testing.assert_allclose(x, ref.x[0].numpy(), atol=5e-3, rtol=1e-2)


def test_pad_rows_and_the_unsharded_path():
    """pad_rows pads with 0 ≤ 0 ≤ 0 rows; with no mesh solve_tp is the
    same arithmetic with no collectives, a lane per QP (two lanes solve
    as each alone), and it never polishes, as JAX's."""
    P, q, A, l, u = (torch.as_tensor(a) for a in _case("row_padding"))
    A8, l8, u8, m = pad_rows(A, l[None], u[None], 8)
    assert m == 5 and A8.shape == (8, 10) and l8.shape == u8.shape == (1, 8)
    assert torch.equal(A8[:5], A) and not A8[5:].any()
    assert not l8[:, 5:].any() and not u8[:, 5:].any()
    assert pad_rows(A, l, u, 5)[0] is A

    s = tadmm.ADMMSettings(max_iter=MAX_ITER, polish=False)
    one = solve_tp(P, q[None], A, l[None], u[None], None, s)
    two = solve_tp(P, torch.stack([q, -q]), A, torch.stack([l, l]),
                   torch.stack([u, u]), None, s)
    for f in ("x", "y", "z", "status", "pri_res", "dua_res"):
        assert torch.equal(getattr(two, f)[:1], getattr(one, f)), f
    polished = solve_tp(P, q[None], A, l[None], u[None], None,
                        tadmm.ADMMSettings(max_iter=MAX_ITER))
    assert torch.equal(polished.x, one.x)
