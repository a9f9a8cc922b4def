"""Process meshes for scenario- and row-parallel solves (counterpart of
``ironcub_mpc_tpu/parallel/mesh.py``).

The JAX package lays devices out on a ``("scenario", "kkt")`` mesh and
shards with ``shard_map``. Here one process drives one device and
``torch.distributed`` joins the processes, laid out as JAX lays out its
devices, ``reshape(n_scenario, n_kkt)``: rank r has scenario coordinate
``r // n_kkt`` and kkt coordinate ``r % n_kkt``.

- axis ``"scenario"``: data parallelism over Monte-Carlo rollouts; each
  scenario coordinate runs its own slice of the lanes, and statistics are
  reduced over the ranks that share a kkt coordinate (the scenario group).
- axis ``"kkt"``: tensor parallelism inside one QP solve
  (:mod:`.tp_admm`); the ranks that share a scenario slice (the kkt group)
  each hold a block of constraint rows, and a sweep runs replicated on
  them.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on an ``(n_scenario, n_kkt)`` mesh of
    ``world_size`` processes: ``rank`` on ``device``. ``scenario_group``
    joins the ranks that share this rank's kkt coordinate and
    ``kkt_group`` the ranks that share its scenario coordinate
    (``torch.distributed`` process groups; None where the group is this
    process alone)."""

    world_size: int
    rank: int
    device: torch.device
    n_kkt: int = 1
    scenario_group: object = None
    kkt_group: object = None

    @property
    def n_scenario(self) -> int:
        return self.world_size // self.n_kkt

    @property
    def scenario_index(self) -> int:
        return self.rank // self.n_kkt

    @property
    def kkt_index(self) -> int:
        return self.rank % self.n_kkt

    @property
    def shape(self) -> dict:
        """The axis sizes, as JAX's ``Mesh.shape``."""
        return {"scenario": self.n_scenario, "kkt": self.n_kkt}


def _group(ranks, world):
    """A process group of ``ranks``: WORLD when they are the world, None
    when they are one process. Every rank must call this for every group, in
    the same order (``dist.new_group`` is collective)."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(n_scenario: int | None = None, n_kkt: int = 1,
              device=None) -> Mesh:
    """The ``(n_scenario, n_kkt)`` mesh of the processes of this run: every
    process of an initialised ``torch.distributed`` world (see
    :func:`multihost_init`), or this process alone. ``n_scenario`` defaults
    to the world size over ``n_kkt``; the two must multiply to the world
    size. ``device`` is this rank's device: ``cuda`` unless the caller asks
    for another, the card ``rank % device_count`` when several processes
    share a host. Collective: every rank calls it with the same axes."""
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if n_kkt < 1:
        raise ValueError(f"n_kkt must be >= 1, got {n_kkt}")
    if n_scenario is None:
        n_scenario = world // n_kkt
    if n_scenario * n_kkt != world:
        raise ValueError(f"a ({n_scenario}, {n_kkt}) mesh needs "
                         f"{n_scenario * n_kkt} processes but the world has "
                         f"{world}: one process drives one device")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world > 1:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    scenario_group = kkt_group = None
    for s in range(n_scenario):
        g = _group(range(s * n_kkt, (s + 1) * n_kkt), world)
        if s == rank // n_kkt:
            kkt_group = g
    for k in range(n_kkt):
        g = _group(range(k, world, n_kkt), world)
        if k == rank % n_kkt:
            scenario_group = g
    return Mesh(world_size=world, rank=rank, device=dev, n_kkt=n_kkt,
                scenario_group=scenario_group, kkt_group=kkt_group)


def scenario_shard(mesh: Mesh | None, n: int) -> slice:
    """The lanes of ``n`` that this rank runs: equal contiguous slices by
    scenario coordinate, as the JAX ``shard_map`` over the scenario axis
    takes them (``n`` must divide evenly); the ranks of one kkt group run
    the same lanes."""
    parts = 1 if mesh is None else mesh.n_scenario
    index = 0 if mesh is None else mesh.scenario_index
    if n % parts:
        raise ValueError(f"{n} scenarios do not divide over {parts} "
                         "scenario ranks")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def pick_backend(ranks_per_host: int) -> str:
    """The ``torch.distributed`` backend for ``ranks_per_host`` processes on
    one host: ``nccl`` when each has a card of its own, else ``gloo`` (on
    the CPU, and where ranks share a card: NCCL refuses two ranks on one
    GPU; gloo moves CUDA tensors through host memory)."""
    if torch.cuda.is_available() and \
            ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def multihost_init(backend: str | None = None) -> bool:
    """Join the ``torch.distributed`` world that ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` describe, over ``backend``
    (by default :func:`pick_backend` of ``LOCAL_WORLD_SIZE``, else
    ``WORLD_SIZE``); the backend is printed. A no-op, returning False, when
    they are not set or the world is already joined. Call before
    :func:`make_mesh`."""
    if dist.is_initialized():
        return False
    if not all(k in os.environ for k in ("MASTER_ADDR", "RANK",
                                         "WORLD_SIZE")):
        return False
    if backend is None:
        backend = pick_backend(int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])))
    print(f"multihost_init: rank {os.environ['RANK']} of "
          f"{os.environ['WORLD_SIZE']} joins over {backend}", flush=True)
    dist.init_process_group(backend, init_method="env://")
    return True
