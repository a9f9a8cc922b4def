"""The multi-process dry run: every parallel axis of the port on one mesh
(counterpart of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` spawns ``n`` ranks joined by ``torch.distributed``
on a ``(n/2, 2)`` (scenario, kkt) mesh when n is even, else ``(n, 1)``, and
runs, in JAX's order:

1. a toy-horizon sharded sweep, one tick (data parallel over scenarios,
   replicated over kkt);
2. a 24 × 16 row-sharded ADMM solve over the kkt axis (when n_kkt > 1);
3. the same sweep at the flagship 588-variable configuration with the
   batch-wide guard;
4. the pod-scale sweep: ``pod_lanes`` scenarios (16,384 by default) over a
   ``(n, 1)`` mesh, 4 ticks in 2-tick chunks, checkpointed, with one resume
   after the first chunk;
5. on rank 0, a pipelined tick over four stages on its own device.

The backend is ``gloo`` on the CPU and wherever ranks share a card,
``nccl`` with a card a rank (:func:`~.mesh.pick_backend`); it is printed.
The kernels keep ``kernel_mode="auto"``: on the card they run where JAX's
dry run switched Pallas off for its virtual CPU devices.

    python -m ironcub_mpc_tpu_torch.parallel.dryrun N [--device cpu]
                                                      [--pod-lanes K]
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

POD_LANES = 16384


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stats(res) -> dict:
    return dict(n_scenarios=int(res.n_scenarios),
                solved_frac=float(res.solved_frac),
                mean_com_err=float(res.mean_com_err),
                status_counts=res.status_counts.tolist())


def _rank(rank, world, port, device, backend, threads, pod_lanes, workdir):
    """One rank of the dry run; rank 0 writes the summary to
    ``workdir/summary.json``."""
    import torch.distributed as dist

    from ..core.config import MPCConfig, RobotConfig, SimConfig
    from ..core.types import expand_lanes
    from ..dynamics import KinDyn, load_ironcub_model
    from ..ops import admm, kernels
    from ..runtime.loop import ClosedLoop
    from ..sim.plant import Plant
    from . import (ScenarioConfig, make_batched_carry, make_mesh,
                   multihost_init, run_sweep)
    from .pp_pipeline import N_STAGES, pipeline_tick
    from .tp_admm import solve_tp

    torch.set_num_threads(threads)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    multihost_init(backend)
    summary = dict(backend=backend, world=world, parts_s={})
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        summary["parts_s"][name] = now - t_part
        t_part = now

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    try:
        n_kkt = 2 if world % 2 == 0 else 1
        mesh = make_mesh(n_scenario=world // n_kkt, n_kkt=n_kkt,
                         device=device)
        dev = mesh.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        summary["mesh"] = mesh.shape
        say(f"dryrun mesh: {mesh.shape} over {backend}, rank 0 on {dev}")

        # tiny multi-rate horizon (still 2-rate: 2 small + 2 large steps);
        # enough iterations + polish that its solves report SOLVED
        cfg = dataclasses.replace(
            MPCConfig(), n_iter=4, n_iter_small=2, control_horizon=3)
        settings = admm.ADMMSettings(max_iter=150, polish=True,
                                     rho_update_iters=(40,))
        model = load_ironcub_model()
        plant = Plant(KinDyn(model, device=dev), RobotConfig(),
                      SimConfig(use_nn_jet_dynamics=False))
        loop = ClosedLoop(plant, cfg, settings)
        q0 = np.radians(SimConfig().initial_position_deg)
        s = plant.init_state(np.eye(3), np.array([0.0, 0.0, 0.8]), q0,
                             thrust0=model.total_mass * 9.81 / 4.0)
        channels = {k: np.zeros((5, 3)) for k in
                    ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
        problem, carry = loop.configure(s, channels, np.full(100, 1.0))

        # --- DP axis: the sharded sweep step --------------------------------
        scen = ScenarioConfig(wind_force_std=1.0, thrust_scale_std=0.01,
                              base_vel_std=0.01, joint_pos_std=0.001)
        n_scen = mesh.n_scenario * 2
        res = run_sweep(loop, problem,
                        make_batched_carry(carry, n_scen, scen, seed=0),
                        n_ticks=1, mesh=mesh, scen=scen)
        if not np.isfinite(float(res.mean_com_err)):
            raise RuntimeError(f"dryrun sweep: {res}")
        summary["sweep"] = _stats(res)
        say(f"sweep: {int(res.n_scenarios)} scenarios, solved_frac="
            f"{float(res.solved_frac):.2f}, mean_com_err="
            f"{float(res.mean_com_err):.4f}")
        part("sweep")

        # --- TP axis: the row-sharded ADMM solve over 'kkt' -------------------
        if n_kkt > 1:
            rng = np.random.default_rng(0)
            n, m = 24, 16
            M = rng.normal(size=(n, n))

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            sol = solve_tp(t(M @ M.T + np.eye(n)), t(rng.normal(size=n))[None],
                           t(rng.normal(size=(m, n))), t(-np.ones((1, m))),
                           t(np.ones((1, m))), mesh,
                           admm.ADMMSettings(max_iter=50, polish=False))
            if not bool(torch.isfinite(sol.x).all()):
                raise RuntimeError(f"dryrun tp solve: {sol}")
            summary["tp"] = dict(status=int(sol.status),
                                 pri_res=float(sol.pri_res))
            say(f"tp solve: status={int(sol.status)} "
                f"pri={float(sol.pri_res):.2e}")
            part("tp")

        # --- flagship shapes: the same sweep at the 588-variable config, the
        # batch-wide guard on -------------------------------------------------
        settings_full = admm.ADMMSettings(
            max_iter=200, polish=True, rho_update_iters=(25, 75),
            batch_guard=True)
        loop_full = ClosedLoop(plant, MPCConfig(), settings_full)
        channels_full = {k: np.zeros((30, 3)) for k in channels}
        problem_f, carry_f = loop_full.configure(s, channels_full,
                                                 np.full(600, 1.0))
        kernels.reset_launches()
        res_f = run_sweep(loop_full, problem_f,
                          make_batched_carry(carry_f, n_scen, scen, seed=1),
                          n_ticks=1, mesh=mesh, scen=scen)
        launches = {"admm_segment": kernels.admm_segment.launches,
                    "woodbury_ns": kernels.woodbury_ns.launches}
        if not np.isfinite(float(res_f.mean_com_err)):
            raise RuntimeError(f"dryrun flagship sweep: {res_f}")
        summary["flagship"] = dict(_stats(res_f), launches=launches)
        say(f"flagship sweep (588-var): {int(res_f.n_scenarios)} scenarios, "
            f"solved_frac={float(res_f.solved_frac):.2f}, mean_com_err="
            f"{float(res_f.mean_com_err):.4f}, kernel launches {launches}")
        part("flagship")

        # --- pod scale: the chunked, checkpointed sweep with one resume ------
        mesh16 = make_mesh(n_scenario=world, n_kkt=1, device=dev)
        scen16 = ScenarioConfig(wind_force_std=1.0, thrust_scale_std=0.01,
                                base_vel_std=0.01, joint_pos_std=0.001)
        ck = str(Path(workdir) / "pod_ck")
        # the first 2-tick chunk, then "crash"; the second call restores the
        # persisted (carry, accumulators, cursor) and continues to 4
        run_sweep(loop, problem,
                  make_batched_carry(carry, pod_lanes, scen16, seed=16),
                  n_ticks=2, mesh=mesh16, scen=scen16, chunk_ticks=2,
                  checkpoint_dir=ck)
        res16 = run_sweep(loop, problem,
                          make_batched_carry(carry, pod_lanes, scen16,
                                             seed=16),
                          n_ticks=4, mesh=mesh16, scen=scen16, chunk_ticks=2,
                          checkpoint_dir=ck)
        cnt16 = res16.status_counts.tolist()
        if not np.isfinite(float(res16.mean_com_err)) or \
                sum(cnt16[:5]) != pod_lanes * 4:
            raise RuntimeError(f"dryrun pod-scale sweep: {res16}")
        summary["pod"] = _stats(res16)
        say(f"pod-scale sweep: {pod_lanes} scenarios x 4 ticks over {world} "
            f"ranks (2-tick chunks, checkpointed, one mid-sweep resume), "
            f"solved_frac={float(res16.solved_frac):.2f}, "
            f"status_counts={cnt16}")
        part("pod")

        # --- PP axis: the 4-stage pipelined tick, on rank 0 ------------------
        if rank == 0:
            snap0, _ = loop.snapshot(s)
            B = 2 * N_STAGES
            _, pp_out = pipeline_tick(
                cfg, loop.sched, loop.sel, settings, problem,
                expand_lanes(carry.mpc, B), expand_lanes(snap0, B),
                torch.zeros((B, 4), device=dev), [dev] * N_STAGES)
            if not bool(torch.isfinite(pp_out.throttle).all()):
                raise RuntimeError(f"dryrun pipelined tick: {pp_out}")
            summary["pipeline"] = dict(statuses=pp_out.status.tolist())
            say(f"pp pipeline: {B} scenarios through {N_STAGES} stages, "
                f"statuses={pp_out.status[:4].tolist()}")
            part("pipeline")
            (Path(workdir) / "summary.json").write_text(json.dumps(summary))
        dist.barrier()
        say("dryrun_multichip OK")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_processes: int, device=None,
                     pod_lanes: int = POD_LANES) -> dict:
    """Spawn ``n_processes`` ranks and run the dry run on them (``device``:
    ``cuda`` unless the caller asks for another; ``pod_lanes`` scenarios in
    the pod-scale sweep, a multiple of ``n_processes``). Returns rank 0's
    summary: mesh, backend, each part's statistics and seconds, and the
    flagship sweep's kernel launches on rank 0."""
    import torch.multiprocessing as mp

    from .. import resolve_device
    from .mesh import pick_backend

    dev = resolve_device(device)
    backend = pick_backend(n_processes) if dev.type == "cuda" else "gloo"
    print(f"dryrun_multichip: {n_processes} ranks on {dev.type}, backend "
          f"{backend}", flush=True)
    threads = max(1, torch.get_num_threads() // n_processes)
    with tempfile.TemporaryDirectory() as workdir:
        mp.spawn(_rank, args=(n_processes, _free_port(), str(dev), backend,
                              threads, pod_lanes, workdir),
                 nprocs=n_processes, join=True)
        return json.loads((Path(workdir) / "summary.json").read_text())


def main(argv) -> int:
    opts = dict(device=None, pod_lanes=POD_LANES)
    args = list(argv)
    n = int(args.pop(0)) if args and not args[0].startswith("--") else 8
    while args:
        flag = args.pop(0)
        if flag == "--device":
            opts["device"] = args.pop(0)
        elif flag == "--pod-lanes":
            opts["pod_lanes"] = int(args.pop(0))
        else:
            raise SystemExit(f"unknown argument {flag!r}")
    print(json.dumps(dryrun_multichip(n, **opts)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
