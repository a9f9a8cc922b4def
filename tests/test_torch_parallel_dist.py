"""The port's two-axis process mesh and its dry run, over ``gloo`` processes
on the CPU.

- The sweep on a ``(2, 2)`` (scenario, kkt) mesh of four ranks against the
  same sweep on a ``(2, 1)`` mesh of two: each scenario slice runs its 4 of
  the 8 lanes on both ranks of its kkt group, the statistics are reduced
  over the scenario axis only, so every count and per-lane vector is equal
  and the CoM errors agree within 1e-6 m (the bound of
  tests/test_torch_sweep_dist.py; equal bit for bit here, both meshes run
  one slice's lanes alike). Plain and resumed from a checkpoint after the
  first tick, which each kkt group writes once, from its kkt coordinate 0.
  Both worlds are spawned at once; no JAX.
- Each rank's coordinates and the ranks of its two process groups, as JAX
  lays a ``(n_scenario, n_kkt)`` mesh out (``reshape``, row-major).
- ``dryrun_multichip(4)``: the ``(2, 2)`` mesh, every part, the pod-scale
  sweep cut to 64 lanes (16,384, JAX's count, in the ``slow`` case).
"""

import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.config import MPCConfig, RobotConfig, SimConfig
from ironcub_mpc_tpu_torch.dynamics import KinDyn, load_ironcub_model
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.parallel import (
    Mesh, ScenarioConfig, make_batched_carry, make_mesh, multihost_init,
    pick_backend, run_sweep, scenario_shard)
from ironcub_mpc_tpu_torch.parallel.dryrun import POD_LANES, dryrun_multichip
from ironcub_mpc_tpu_torch.runtime import flight
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
from ironcub_mpc_tpu_torch.sim.plant import Plant

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES, N_TICKS = 8, 2
SCEN = ScenarioConfig(wind_force_std=2.0, thrust_scale_std=0.02,
                      base_vel_std=0.01, joint_pos_std=0.002)
CHANNELS = {k: np.zeros((30, 3)) for k in
            ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
ALPHA = np.full(600, 0.08)
# (world, n_kkt): the two-axis mesh and its one-axis reference
WORLDS = ((4, 2), (2, 1))


def _loop():
    kd = KinDyn(load_ironcub_model(), device="cpu")
    plant = Plant(kd, RobotConfig(), SimConfig(use_nn_jet_dynamics=False))
    return ClosedLoop(plant, MPCConfig(),
                      admm.ADMMSettings(max_iter=60, batch_guard=True))


def _worker(rank, world, n_kkt, port, problem, batched, ckdir, out):
    """One rank: its mesh coordinates and groups, the plain sweep and the
    sweep resumed after its first tick, to ``out``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    assert multihost_init("gloo")
    try:
        mesh = make_mesh(n_scenario=world // n_kkt, n_kkt=n_kkt,
                         device="cpu")

        def ranks(g):
            return [] if g is None else dist.get_process_group_ranks(g)

        loop = _loop()

        def sweep(n_ticks, **kw):
            return run_sweep(loop, problem, batched, n_ticks, mesh=mesh,
                             scen=SCEN, recover=True, **kw)._asdict()

        res = sweep(N_TICKS)
        sweep(1, chunk_ticks=1, checkpoint_dir=ckdir)
        resumed = sweep(N_TICKS, chunk_ticks=1, checkpoint_dir=ckdir)
        torch.save(dict(coords=(mesh.scenario_index, mesh.kkt_index),
                        shape=mesh.shape,
                        scenario_ranks=ranks(mesh.scenario_group),
                        kkt_ranks=ranks(mesh.kkt_group),
                        res=res, resumed=resumed), out)
    finally:
        dist.destroy_process_group()


def _free_ports(n):
    """``n`` distinct free ports (the sockets are held open together, so
    the system cannot hand out one port twice)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both meshes' ranks, spawned at once: {(world, n_kkt): (per-rank
    records, checkpoint directory)}."""
    loop = _loop()
    s = flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg)
    problem, carry = loop.configure(loop.settle(s, 0.05), CHANNELS, ALPHA)
    batched = make_batched_carry(carry, N_LANES, SCEN, seed=3)

    tmp = tmp_path_factory.mktemp("mesh")
    ctx = multiprocessing.get_context("spawn")
    procs, files = [], {}
    for (world, n_kkt), port in zip(WORLDS, _free_ports(len(WORLDS))):
        ck = tmp / f"ck{world}x{n_kkt}"
        outs = [tmp / f"w{world}x{n_kkt}r{r}.pt" for r in range(world)]
        files[world, n_kkt] = (outs, ck)
        procs += [ctx.Process(target=_worker, args=(
            r, world, n_kkt, port, problem, batched, str(ck), str(outs[r])))
            for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
        alive = p.is_alive()
        if alive:
            p.kill()
        assert not alive and p.exitcode == 0, p.exitcode
    return {key: ([torch.load(o, weights_only=True) for o in outs], ck)
            for key, (outs, ck) in files.items()}


def test_mesh_shapes(worlds):
    """Rank r of a (n_scenario, n_kkt) mesh sits at (r // n_kkt, r % n_kkt);
    its kkt group is its row, its scenario group its column."""
    for (world, n_kkt), (recs, _) in worlds.items():
        n_s = world // n_kkt
        for r, rec in enumerate(recs):
            s, k = r // n_kkt, r % n_kkt
            assert rec["shape"] == {"scenario": n_s, "kkt": n_kkt}
            assert rec["coords"] == (s, k)
            assert rec["kkt_ranks"] == (
                [s * n_kkt + j for j in range(n_kkt)] if n_kkt > 1 else [])
            assert rec["scenario_ranks"] == list(range(k, world, n_kkt))
    mesh = Mesh(world_size=6, rank=5, device=torch.device("cpu"), n_kkt=3)
    assert (mesh.n_scenario, mesh.scenario_index, mesh.kkt_index) == (2, 1, 2)
    assert scenario_shard(mesh, 8) == slice(4, 8)
    assert pick_backend(1) == ("nccl" if torch.cuda.is_available()
                               else "gloo")
    assert pick_backend(torch.cuda.device_count() + 1) == "gloo"


def test_two_axis_sweep_equals_the_one_axis_sweep(worlds):
    (two, ck_two), (one, ck_one) = worlds[4, 2], worlds[2, 1]
    for recs in (two, one):
        for rec in recs[1:]:          # every rank holds the whole result
            for key in ("res", "resumed"):
                for f, v in rec[key].items():
                    assert torch.equal(v, recs[0][key][f]), (key, f)
    a, b = two[0], one[0]
    for key in ("res", "resumed"):
        ra, rb = a[key], b[key]
        for f in ("n_scenarios", "n_failed", "n_solver_bad", "status_counts",
                  "n_ticks_recovered", "n_ticks_retried", "lane_solver_bad",
                  "solved_frac"):
            assert torch.equal(ra[f], rb[f]), (key, f)
        assert int(ra["status_counts"][:5].sum()) == N_LANES * N_TICKS
        for f in ("lane_max_err", "mean_com_err", "max_com_err"):
            np.testing.assert_allclose(ra[f].numpy(), rb[f].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{key} {f}")
    # the resumed sweep is the uninterrupted one
    for f, v in a["res"].items():
        np.testing.assert_allclose(a["resumed"][f].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=f)
    # one checkpoint file a scenario slice, on both meshes
    names = ["sweep_state.rank0-of-2.pt", "sweep_state.rank1-of-2.pt"]
    assert sorted(p.name for p in ck_two.iterdir()) == names
    assert sorted(p.name for p in ck_one.iterdir()) == names


def _check_dryrun(summary, pod_lanes):
    assert summary["backend"] == "gloo" and summary["world"] == 4
    assert summary["mesh"] == {"scenario": 2, "kkt": 2}
    assert summary["sweep"]["n_scenarios"] == 4
    assert summary["tp"]["status"] == admm.SOLVED
    assert summary["flagship"]["n_scenarios"] == 4
    assert sum(summary["pod"]["status_counts"][:5]) == pod_lanes * 4
    assert len(summary["pipeline"]["statuses"]) == 8
    for part in ("sweep", "flagship", "pod"):
        assert summary[part]["solved_frac"] == 1.0, (part, summary[part])
    assert set(summary["parts_s"]) == {"sweep", "tp", "flagship", "pod",
                                       "pipeline"}


def test_dryrun_multichip_on_four_cpu_ranks():
    _check_dryrun(dryrun_multichip(4, device="cpu", pod_lanes=64), 64)


@pytest.mark.slow
def test_dryrun_multichip_pod_scale():
    """JAX's pod-scale count: 16,384 lanes over four CPU ranks."""
    _check_dryrun(dryrun_multichip(4, device="cpu"), POD_LANES)
