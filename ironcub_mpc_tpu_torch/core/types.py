"""Tensor containers of the MPC pipeline.

Counterparts of ``ironcub_mpc_tpu/core/types.py`` with the same field names
and order. Every tensor of a :class:`RobotSnapshot`, :class:`MPCCarry` and
:class:`MPCOutput` carries a leading batch dimension B (one lane per
scenario; B = 1 on the real-time path) where the JAX package is ``vmap``-ed.
Shapes below are per lane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class RobotSnapshot(NamedTuple):
    """Kinodynamic quantities of one measured robot state (J = 23 joints,
    4 jets)."""

    w_R_b: torch.Tensor              # [3,3] world-from-base rotation
    base_pos: torch.Tensor           # [3]   base origin, world
    base_ang_vel_world: torch.Tensor  # [3]  measured base angular velocity (world)
    com_pos: torch.Tensor            # [3]   CoM position, world
    total_mass: torch.Tensor         # []    robot mass
    momentum_body: torch.Tensor      # [6]   centroidal momentum, body coords
    inertia_locked: torch.Tensor     # [3,3] locked inertia at CoM, body orientation
    amom_jets_body: torch.Tensor     # [6,4] thrust->momentum-rate map, body coords
    jet_axes_world: torch.Tensor     # [4,3] jet thrust axes, world
    jet_arms_world: torch.Tensor     # [4,3] jet application arms (r_jet - CoM), world
    jac_jets_lin_joints: torch.Tensor  # [4,3,J] linear rows of world jet Jacobians
    jac_com_joints: torch.Tensor     # [3,J] CoM Jacobian, joint cols
    rel_jac_lin: torch.Tensor        # [4,3,J] linear rows of base-relative jet Jacobians
    rel_jac_ang: torch.Tensor        # [4,3,J] angular rows of base-relative jet Jacobians
    joint_pos: torch.Tensor          # [J]   measured joint positions
    jet_thrusts: torch.Tensor        # [4]   estimated/applied thrusts [N]
    ext_wrench_sum: torch.Tensor = None  # [6] total external wrench, world
    zmp: torch.Tensor = None             # [3] zero-moment point
    on_ground: torch.Tensor = None       # [] contact flag


class MPCCarry(NamedTuple):
    """All cross-tick state of the multi-rate MPC."""

    rpy_old: torch.Tensor            # [3]
    n_turns: torch.Tensor            # [3] int32
    throttle_counter: torch.Tensor   # [] int32
    ref_counter: torch.Tensor        # [] int32
    pos_com_ref: torch.Tensor        # [3, n_ref]
    lin_mom_ref: torch.Tensor        # [3, n_ref]
    rpy_ref: torch.Tensor            # [3, n_ref]
    ang_mom_ref: torch.Tensor        # [3, n_ref]
    pos_com_ref_now: torch.Tensor    # [3]
    rpy_ref_now: torch.Tensor        # [3]
    mom_ref_now: torch.Tensor        # [6]
    pos_traj_idx: torch.Tensor       # [] int32
    alpha_traj_idx: torch.Tensor     # [] int32
    alpha_gravity: torch.Tensor      # []
    thrust_des: torch.Tensor         # [4]
    thrust_dot_des: torch.Tensor     # [4]
    throttle_cmd: torch.Tensor       # [4] physical % throttle last commanded
    joints_pos_ref: torch.Tensor     # [J]
    warm_x: torch.Tensor             # [nU] ADMM warm start (unscaled);
    #                                  [n_var] for the full-space solver
    warm_y: torch.Tensor             # [n_box]; [n_constraints] full-space
    kinv: torch.Tensor = None        # [nU, nU] carried (K(ρ))⁻¹, scaled space
    rho_vec: torch.Tensor = None     # [n_box]
    rho_scalar: torch.Tensor = None  # []


class DebugInfo(NamedTuple):
    """Per-tick QP introspection of debug-log mode
    (``MPCConfig.enable_debug_log_mode``; ``MPCOutput.debug`` is None with
    the flag off): per-block ½xᵀH_b x + g_bᵀx and the lb ≤ Ax ≤ ub triples
    of the reference's constraint stack, costs and Ax zeroed on a lane that
    did not solve."""

    total_cost: torch.Tensor     # []    sum of the block costs
    block_costs: torch.Tensor    # [4]   tracking, regularisation, initial
    #                                    throttle, joint position
    constraint_lb: torch.Tensor  # [n_constraints]
    constraint_ax: torch.Tensor  # [n_constraints]
    constraint_ub: torch.Tensor  # [n_constraints]


class MPCOutput(NamedTuple):
    """Per-tick controller output."""

    joints_pos_ref: torch.Tensor     # [J] absolute joint position reference
    throttle: torch.Tensor           # [4] physical throttle command [%]
    thrust_des: torch.Tensor         # [4] predicted thrust at knot 1
    thrust_dot_des: torch.Tensor     # [4]
    final_state: torch.Tensor        # [26] terminal predicted state
    status: torch.Tensor             # [] int32 solver status code
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    alpha_gravity: torch.Tensor
    pos_com_ref: torch.Tensor        # [3]
    rpy_ref: torch.Tensor            # [3]
    mom_ref: torch.Tensor            # [6]
    guard_fired: torch.Tensor = None  # [] bool
    debug: DebugInfo = None


def tree_map(fn, tree, *rest, path: str | None = None):
    """``fn`` over the leaves of named-tuple trees of one structure, leaf by
    leaf: ``fn(leaf, *leaves of rest)``, or ``fn(dotted path, leaf, ...)``
    given ``path``, the prefix of the paths (``"carry"`` gives
    ``"carry.plant.base_p"``). A None leaf of ``tree`` stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        names = tree._fields
        return type(tree)(*(
            tree_map(fn, *leaves,
                     path=None if path is None else f"{path}.{name}")
            for name, *leaves in zip(names, tree, *rest)))
    return fn(tree, *rest) if path is None else fn(path, tree, *rest)


def expand_lanes(nt, batch: int):
    """Repeat every tensor of a one-lane container ``batch`` times along the
    leading dimension (None fields stay None)."""
    return tree_map(lambda t: t.expand(batch, *t.shape[1:]).contiguous(), nt)


@functools.lru_cache(maxsize=None)
def index_tensor(idx: tuple, device) -> torch.Tensor:
    """The static index tuple ``idx`` as a long tensor on ``device``, made
    once. Indexing with a Python list copies the list to the device on every
    call, and that copy makes the host wait for the stream; callers must not
    write into the returned tensor."""
    return torch.tensor(idx, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def const_tensor(values, dtype, device) -> torch.Tensor:
    """A static scalar or tuple of scalars as a tensor on ``device``, made
    once (see :func:`index_tensor`); read-only for its callers."""
    return torch.tensor(values, dtype=dtype, device=device)
