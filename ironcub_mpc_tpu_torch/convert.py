"""State carried across from the JAX package, and back.

The JAX package's ``MPCProblem``, ``MPCCarry``, ``RobotSnapshot``,
``PlantState`` and ``LoopCarry`` come in as numpy leaves — a mapping of field name to array, or any named tuple with
``_asdict()`` (what ``jax.tree.map(np.asarray, ...)`` returns) — so both
packages can start a tick from bit-identical state without this package
importing JAX. The converters return this package's containers on a given
device; :func:`to_numpy` goes the other way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.types import MPCCarry, RobotSnapshot, tree_map
from .ops.admm import Scaling
from .qp.blocks import LambdaInit
from .qp.condensed import CondensedScaling
from .qp.mpc import MPCProblem
from .runtime.loop import LoopCarry
from .sim.ekf import EKFState
from .sim.plant import PlantState


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
    package's problem as numpy leaves: a condensed problem with its
    ``cond_scaling``, or a full-space one with its Ruiz ``scaling`` and
    ``cond_scaling`` None."""
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
    lane (leading dimension 1). A full-space carry keeps its warm start over
    the whole decision vector and the constraint rows, and ``kinv``,
    ``rho_vec`` and ``rho_scalar`` None."""
    return _container(MPCCarry, carry, device, batched)


def snapshot_from_numpy(snap, device, batched: bool = False) -> RobotSnapshot:
    """The port's :class:`RobotSnapshot`; an unbatched JAX snapshot becomes
    one lane (leading dimension 1)."""
    return _container(RobotSnapshot, snap, device, batched)


def plant_state_from_numpy(state, device, batched: bool = False) -> PlantState:
    """The port's :class:`PlantState`; an unbatched JAX state becomes one
    lane. The JAX state's PRNG key has no counterpart (the port's plant owns
    its noise generator), so ``rng`` is None."""
    src = _fields(state)
    out = {k: _tensor(src.get(k), device, batched)
           for k in PlantState._fields if k not in ("ekf", "rng")}
    return PlantState(ekf=_container(EKFState, src["ekf"], device, batched),
                      rng=None, **out)


def loop_carry_from_numpy(carry, device, batched: bool = False) -> LoopCarry:
    """The port's :class:`LoopCarry` (plant state, MPC carry and the two
    telemetry filters)."""
    src = _fields(carry)
    return LoopCarry(
        plant=plant_state_from_numpy(src["plant"], device, batched),
        mpc=carry_from_numpy(src["mpc"], device, batched),
        base_lin_vel_filt=_tensor(src["base_lin_vel_filt"], device, batched),
        base_ang_vel_filt=_tensor(src["base_ang_vel_filt"], device, batched))


def lstm_from_numpy(weights, device, dtype=torch.float32):
    """An :class:`LSTMJetModel` from a mapping with the keys of
    ``data/jet_lstm_weights.npz`` (weights, biases and the four
    normalisation scalars), without reading a file."""
    from .sim.jet_lstm import LSTMJetModel

    return LSTMJetModel(dict(weights), dtype=dtype, device=device)


def to_device(obj, device):
    """Tensors (also inside named tuples) moved to ``device``; None stays
    None."""
    return tree_map(lambda t: t.to(device), obj)


def to_numpy(obj):
    """Tensors (also inside named tuples such as a tick's output and its
    :class:`~ironcub_mpc_tpu_torch.core.types.DebugInfo`, lists and dicts)
    to numpy arrays on the host; None stays None."""
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
