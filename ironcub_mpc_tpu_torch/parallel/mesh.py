"""Process meshes for scenario-parallel sweeps (counterpart of
``ironcub_mpc_tpu/parallel/mesh.py``).

The JAX package lays devices out on a ``("scenario", "kkt")`` mesh and
shards the batch with ``shard_map``. Here one process drives one device and
``torch.distributed`` joins the processes: the scenario axis is the world of
processes, each rank runs its own slice of the lanes, and statistics are
reduced with collectives. The ``"kkt"`` axis (tensor parallelism inside one
QP solve, ``parallel/tp_admm.py``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The scenario axis of a sweep: ``world_size`` processes, this one
    ``rank`` on ``device``; ``group`` is the ``torch.distributed`` process
    group that reduces the statistics, None for one process."""

    world_size: int
    rank: int
    device: torch.device
    group: object = None


def make_mesh(n_scenario: int | None = None, n_kkt: int = 1,
              device=None) -> Mesh:
    """The mesh of the processes of this run: every process of an
    initialised ``torch.distributed`` world (see :func:`multihost_init`), or
    this process alone. ``n_scenario`` must equal the world size when given.
    ``device`` is this rank's device: ``cuda`` unless the caller asks for
    another, the card ``rank % device_count`` when several processes share
    a host."""
    if n_kkt != 1:
        raise NotImplementedError(
            "n_kkt > 1 needs the row-sharded ADMM of parallel/tp_admm.py, "
            "which is not ported yet")
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if n_scenario is not None and n_scenario != world:
        raise ValueError(f"n_scenario={n_scenario} but the world has {world} "
                         "process(es): one process drives one device")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world > 1:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(world_size=world, rank=rank, device=dev,
                group=dist.group.WORLD if world > 1 else None)


def scenario_shard(mesh: Mesh | None, n: int) -> slice:
    """The lanes of ``n`` that this rank runs: equal contiguous slices, as
    the JAX ``shard_map`` over the scenario axis takes them (``n`` must
    divide evenly)."""
    world = 1 if mesh is None else mesh.world_size
    rank = 0 if mesh is None else mesh.rank
    if n % world:
        raise ValueError(f"{n} scenarios do not divide over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def multihost_init() -> bool:
    """Join the ``torch.distributed`` world that ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` describe (``nccl`` where
    there is a card, else ``gloo``). A no-op, returning False, when they are
    not set or the world is already joined. Call before :func:`make_mesh`."""
    if dist.is_initialized():
        return False
    if not all(k in os.environ for k in ("MASTER_ADDR", "RANK",
                                         "WORLD_SIZE")):
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True
