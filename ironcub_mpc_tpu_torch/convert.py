"""State carried across from the JAX package, and back.

The JAX package's ``MPCProblem``, ``MPCCarry`` and ``RobotSnapshot`` come in
as numpy leaves — a mapping of field name to array, or any named tuple with
``_asdict()`` (what ``jax.tree.map(np.asarray, ...)`` returns) — so both
packages can start a tick from bit-identical state without this package
importing JAX. The converters return this package's containers on a given
device; :func:`to_numpy` goes the other way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.types import MPCCarry, RobotSnapshot
from .ops.admm import Scaling
from .qp.blocks import LambdaInit
from .qp.condensed import CondensedScaling
from .qp.mpc import MPCProblem


def _fields(obj) -> dict:
    return dict(obj) if isinstance(obj, Mapping) else obj._asdict()


def _tensor(a, device, batched):
    if a is None:
        return None
    t = torch.as_tensor(np.array(a), device=device)
    return t if batched else t.unsqueeze(0)


def _container(cls, obj, device, batched=True):
    """``cls`` built field by field from ``obj``; a missing or None field
    stays None."""
    src = _fields(obj)
    return cls(**{k: _tensor(src.get(k), device, batched)
                  for k in cls._fields})


def problem_from_numpy(problem, device) -> MPCProblem:
    """The port's :class:`MPCProblem` (no batch dimension) from the JAX
    package's problem as numpy leaves."""
    src = _fields(problem)
    nested = {"lambda_init": LambdaInit, "scaling": Scaling,
              "cond_scaling": CondensedScaling}
    out = {}
    for k in MPCProblem._fields:
        v = src.get(k)
        if v is None:
            out[k] = None
        elif k in nested:
            out[k] = _container(nested[k], v, device)
        else:
            out[k] = _tensor(v, device, batched=True)
    return MPCProblem(**out)


def carry_from_numpy(carry, device, batched: bool = False) -> MPCCarry:
    """The port's :class:`MPCCarry`; an unbatched JAX carry becomes one
    lane (leading dimension 1)."""
    return _container(MPCCarry, carry, device, batched)


def snapshot_from_numpy(snap, device, batched: bool = False) -> RobotSnapshot:
    """The port's :class:`RobotSnapshot`; an unbatched JAX snapshot becomes
    one lane (leading dimension 1)."""
    return _container(RobotSnapshot, snap, device, batched)


def to_numpy(obj):
    """Tensors (also inside named tuples, lists and dicts) to numpy arrays on
    the host; None stays None."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    if isinstance(obj, Mapping):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj
