"""The port's sweep over a mesh of two processes (``torch.distributed`` with
the ``gloo`` backend, on the CPU) against two one-process sweeps of its two
halves, reduced here on the host.

Each rank runs its 4 of the 8 lanes and takes its batch-wide decisions over
them, as a JAX shard does over its own lanes; so the reference is the two
halves swept apart, not one sweep of all 8. Counts and the per-lane vectors
are equal, the CoM statistics agree within 1e-6 m. 2 ticks, no JAX.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.config import MPCConfig, RobotConfig, SimConfig
from ironcub_mpc_tpu_torch.core.types import tree_map
from ironcub_mpc_tpu_torch.dynamics import KinDyn, load_ironcub_model
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.parallel import (
    ScenarioConfig, make_batched_carry, make_mesh, run_sweep)
from ironcub_mpc_tpu_torch.runtime import flight
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
from ironcub_mpc_tpu_torch.sim.plant import Plant

N_LANES, N_TICKS, WORLD = 8, 2, 2
SCEN = ScenarioConfig(wind_force_std=2.0, thrust_scale_std=0.02,
                      base_vel_std=0.01, joint_pos_std=0.002)
CHANNELS = {k: np.zeros((30, 3)) for k in
            ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
ALPHA = np.full(600, 0.08)


def _loop():
    kd = KinDyn(load_ironcub_model(), device="cpu")
    plant = Plant(kd, RobotConfig(), SimConfig(use_nn_jet_dynamics=False))
    return ClosedLoop(plant, MPCConfig(),
                      admm.ADMMSettings(max_iter=60, batch_guard=True))


def _worker(rank, port, problem, batched, out):
    """One rank of the mesh: its half of the lanes, the reduced result to
    ``out``."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_mesh(n_scenario=WORLD, device="cpu")
        assert (mesh.world_size, mesh.rank) == (WORLD, rank)
        res = run_sweep(_loop(), problem, batched, N_TICKS, mesh=mesh,
                        scen=SCEN, recover=True)
        torch.save(res._asdict(), out)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def two_threads():
    """Each rank and this process run on 2 threads, as many as each of
    them had alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_two_process_sweep_equals_its_halves(tmp_path, two_threads):
    loop = _loop()
    s = flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg)
    s = loop.settle(s, 0.05)
    problem, carry = loop.configure(s, CHANNELS, ALPHA)
    batched = make_batched_carry(carry, N_LANES, SCEN, seed=3)

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [tmp_path / f"rank{r}.pt" for r in range(WORLD)]
    procs = [ctx.Process(target=_worker,
                         args=(r, port, problem, batched, str(outs[r])))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    # the reference meanwhile: each half swept in this process alone
    half = N_LANES // WORLD
    halves = [run_sweep(loop, problem,
                        _slice(batched, slice(r * half, (r + 1) * half)),
                        N_TICKS, scen=SCEN, recover=True)
              for r in range(WORLD)]
    for p in procs:
        p.join(timeout=120)
        alive = p.is_alive()
        if alive:
            p.kill()
        assert not alive and p.exitcode == 0, p.exitcode
    got = [torch.load(o, weights_only=True) for o in outs]
    # every rank holds the whole reduced result
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k
    res = got[0]

    a, b = halves
    assert int(res["n_scenarios"]) == N_LANES
    for f in ("n_failed", "n_solver_bad", "n_ticks_recovered",
              "n_ticks_retried", "status_counts"):
        assert torch.equal(res[f], getattr(a, f) + getattr(b, f)), f
    assert int(res["status_counts"][:5].sum()) == N_LANES * N_TICKS
    assert torch.equal(res["lane_solver_bad"],
                       torch.cat([a.lane_solver_bad, b.lane_solver_bad]))
    np.testing.assert_allclose(
        res["lane_max_err"].numpy(),
        torch.cat([a.lane_max_err, b.lane_max_err]).numpy(), rtol=0,
        atol=1e-6)
    n_h = [half - int(h.n_failed) for h in halves]
    mean = (float(a.mean_com_err) * n_h[0] + float(b.mean_com_err) * n_h[1]
            ) / max(sum(n_h), 1)
    np.testing.assert_allclose(float(res["mean_com_err"]), mean, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(res["max_com_err"]),
        max(float(a.max_com_err), float(b.max_com_err)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(res["solved_frac"]),
        (float(a.solved_frac) + float(b.solved_frac)) / 2, rtol=0, atol=1e-7)
    assert int(res["n_failed"]) == 0 and float(res["solved_frac"]) > 0.99


def _slice(tree, sl):
    return tree_map(lambda t: t[sl], tree)


def test_scenarios_must_divide_over_the_ranks():
    from ironcub_mpc_tpu_torch.parallel import Mesh, scenario_shard

    mesh = Mesh(world_size=3, rank=1, device=torch.device("cpu"))
    assert scenario_shard(mesh, 9) == slice(3, 6)
    with pytest.raises(ValueError, match="divide"):
        scenario_shard(mesh, 8)
