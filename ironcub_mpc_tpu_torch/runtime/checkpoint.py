"""Checkpoint / resume of closed-loop and Monte-Carlo state (counterpart of
``ironcub_mpc_tpu/runtime/checkpoint.py``, without Orbax).

A run is defined mid-flight by the :class:`~.loop.LoopCarry` (plant state,
MPC carry with its warm starts, reference windows, trajectory cursors and
multi-rate counters), the :class:`~..qp.mpc.MPCProblem` constants and, with
``simulate_noise``, the plant's sensor-noise generator. The JAX package keeps
the noise key in the carry; here the generator belongs to the
:class:`~..sim.plant.Plant`, so a checkpoint stores its state beside the
trees.

The named-tuple trees are flattened to ``{"carry.plant.base_p": tensor,
...}`` (None fields are left out), written with ``torch.save`` to a
temporary file that is then renamed over the target, and read back with
``torch.load(weights_only=True)``. Restoring rebuilds the trees from
templates of the same structure, shapes and dtypes (the same batch size for
sweep state), and puts every tensor on its template's device.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ..core.types import tree_map

NOISE_KEY = "plant.noise_gen_state"


def flatten(prefix: str, tree) -> dict:
    """``{"prefix.field.sub": tensor}`` for every tensor leaf of a
    named-tuple tree (or a single tensor, under ``prefix``)."""
    out = {}

    def leaf(path, t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{path}: cannot checkpoint a {type(t).__name__}")
        out[path] = t.detach()

    tree_map(leaf, tree, path=prefix)
    return out


def unflatten(flat: dict, prefix: str, like):
    """The tree of ``like`` with every tensor leaf taken from ``flat``,
    checked against the template's shape and dtype and moved to its
    device; an entry saved under ``prefix`` that the template has no leaf
    for (a None field) is refused."""
    used = set()

    def leaf(path, t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{path}: cannot restore a {type(t).__name__}")
        if path not in flat:
            raise ValueError(f"{path}: missing from the checkpoint")
        saved = flat[path]
        if saved.shape != t.shape or saved.dtype != t.dtype:
            raise ValueError(
                f"{path}: saved {saved.dtype} {tuple(saved.shape)}, the "
                f"template is {t.dtype} {tuple(t.shape)}")
        used.add(path)
        return saved.to(t.device)

    out = tree_map(leaf, like, path=prefix)
    extra = sorted(k for k in flat if k not in used
                   and (k == prefix or k.startswith(prefix + ".")))
    if extra:
        raise ValueError(f"{extra[0]}: saved, but the template has None")
    return out


def write(path: str | Path, flat: dict) -> str:
    """``torch.save`` of ``flat`` to a temporary file beside ``path``,
    renamed over it, so a reader never sees a half-written checkpoint."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(flat, tmp)
    os.replace(tmp, path)
    return str(path)


def read(path: str | Path) -> dict:
    """The flat dict a :func:`write` stored, on the CPU."""
    return torch.load(Path(path).absolute(), map_location="cpu",
                      weights_only=True)


def save(path: str | Path, problem, carry, step: int | None = None, *,
         plant=None) -> str:
    """Persist ``problem``, ``carry`` and ``step`` (and, given ``plant``, its
    sensor-noise generator's state) to ``path``; returns the path."""
    flat = {**flatten("problem", problem), **flatten("carry", carry),
            "step": torch.tensor(int(step or 0))}
    if plant is not None:
        flat[NOISE_KEY] = plant.noise_state()
    return write(path, flat)


def restore(path: str | Path, problem_like, carry_like, *, plant=None):
    """``(problem, carry, step)`` from ``path``, built on the templates
    (shapes and dtypes must match what was saved). Given ``plant``, its
    sensor-noise generator is set to the saved state."""
    flat = read(path)
    if plant is not None:
        if NOISE_KEY not in flat:
            raise ValueError(f"{path}: no sensor-noise generator state saved")
        plant.set_noise_state(flat[NOISE_KEY])
    return (unflatten(flat, "problem", problem_like),
            unflatten(flat, "carry", carry_like), int(flat["step"]))
