"""Block-structured assembly of the full-space multi-rate MPC QP
(counterpart of ``ironcub_mpc_tpu/qp/assembly.py``).

Decision vector (588 for the shipped config):
``[x_0..x_nIter | Δq_0..Δq_{ch-1} | v_0..v_{ch-ns}]`` with 26-dim states,
8-dim joint deltas and 4-dim standardised-throttle knots. Constraint rows,
stacked in the reference's registration order:
``[dynamics (26·nIter) | initial state (26) | throttle (4·(nIter-ns+1))
| joint position (8·nIter, when enabled)]``.

The Hessian is assembled once from its block structure (numpy, at
configure). Per tick only the gradient and the dynamics rows change: the
static rows and the placement of the per-step blocks are built once per
(config, schedule, device, dtype) by :func:`_layout`, so a tick writes the
blocks of every lane in a few batched operations and copies nothing from
the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as C
from ..core.config import MPCConfig
from ..core.types import index_tensor
from ..horizon.schedule import HorizonSchedule
from ..ops import jet_model as jm


def state_weight_matrix(cfg: MPCConfig) -> np.ndarray:
    """Block-diagonal per-knot state weight Q."""
    Q = np.zeros((cfg.n_states, cfg.n_states))
    Q[C.COM_POS, C.COM_POS] = np.diag(cfg.weight_com_pos)
    Q[C.LIN_MOM, C.LIN_MOM] = np.diag(cfg.weight_lin_mom)
    Q[C.RPY, C.RPY] = np.diag(cfg.weight_rpy)
    Q[C.ANG_MOM, C.ANG_MOM] = np.diag(cfg.weight_ang_mom)
    Q[C.POS_ERR, C.POS_ERR] = np.diag(cfg.weight_com_pos_error)
    Q[C.RPY_ERR, C.RPY_ERR] = np.diag(cfg.weight_rpy_error)
    return Q


def build_hessian(cfg: MPCConfig) -> np.ndarray:
    """Constant full-space QP Hessian: tracking Q per state knot 1..nIter,
    joint-delta and joint-position regularisation per control knot,
    tridiagonal throttle-rate penalty, initial-throttle weight."""
    n = cfg.n_var
    ns, ni, ch = cfg.n_states, cfg.n_iter, cfg.control_horizon
    nj, nt = cfg.n_ctrl_joints, cfg.n_jets
    H = np.zeros((n, n))
    Q = state_weight_matrix(cfg)
    for i in range(1, ni + 1):
        H[i * ns:(i + 1) * ns, i * ns:(i + 1) * ns] += Q
    jo = cfg.joints_offset
    wj = np.diag(cfg.weight_delta_joint) + (
        cfg.weight_regularization_joint_pos * np.eye(nj))
    for i in range(ch):
        H[jo + i * nj:jo + (i + 1) * nj, jo + i * nj:jo + (i + 1) * nj] += wj
    to = cfg.throttle_offset
    wt = cfg.weight_throttle * np.eye(nt)
    for i in range(ch - cfg.n_iter_small):
        a = to + i * nt
        b = to + (i + 1) * nt
        H[a:a + nt, a:a + nt] += wt
        H[b:b + nt, b:b + nt] += wt
        H[a:a + nt, b:b + nt] -= wt
        H[b:b + nt, a:a + nt] -= wt
    H[to:to + nt, to:to + nt] += cfg.weight_initial_throttle * np.eye(nt)
    return H


def build_state_reference(cfg: MPCConfig, pos_ref, lin_ref, rpy_ref, ang_ref):
    """Expand the rolling window [B, 3, n_ref] into per-knot references
    [B, 26, nIter]: small-step knots track window column 0, large-step knot
    i tracks column i − nIterSmall."""
    cols = index_tensor(
        tuple(0 if i < cfg.n_iter_small else i - cfg.n_iter_small
              for i in range(cfg.n_iter)), pos_ref.device)
    B = pos_ref.shape[0]
    ref = torch.zeros((B, cfg.n_states, cfg.n_iter), dtype=pos_ref.dtype,
                      device=pos_ref.device)
    ref[:, C.COM_POS] = pos_ref[:, :, cols]
    ref[:, C.LIN_MOM] = lin_ref[:, :, cols]
    ref[:, C.RPY] = rpy_ref[:, :, cols]
    ref[:, C.ANG_MOM] = ang_ref[:, :, cols]
    return ref


# ---------------------------------------------------------------------------
# Gradient (per tick)
# ---------------------------------------------------------------------------


def build_gradient(cfg: MPCConfig, Q, state_reference, joint_pos_ctrl,
                   joint_pos_ref_ctrl, throttle_cmd):
    """Per-tick gradient [B, n_var]:

    - tracking: g(knot i) = −Q x_ref(i−1) for i = 1..nIter
    - joint-position regularisation: w (q_out − q_init) per control knot
    - initial-throttle pull: −w v(ū_applied) on throttle knot 0
    """
    B = state_reference.shape[0]
    like = dict(dtype=state_reference.dtype, device=state_reference.device)
    track = -(Q @ state_reference)                       # [B, 26, nIter]
    jreg = cfg.weight_regularization_joint_pos * (
        joint_pos_ctrl - joint_pos_ref_ctrl)             # [B, n_ctrl]
    v_applied = jm.throttle_to_v(throttle_cmd)
    tail = cfg.n_var - cfg.throttle_offset - cfg.n_jets
    return torch.cat([
        torch.zeros((B, cfg.n_states), **like), track.mT.reshape(B, -1),
        jreg.repeat(1, cfg.control_horizon),
        -cfg.weight_initial_throttle * v_applied,
        torch.zeros((B, tail), **like)], dim=-1)


# ---------------------------------------------------------------------------
# Constraints (per tick)
# ---------------------------------------------------------------------------


class _Steps(NamedTuple):
    """Static placement of the per-step dynamics blocks."""

    dts: torch.Tensor          # [nIter] step lengths
    on_diag: torch.Tensor      # [nIter, nIter] diag(Δt): Δtᵢ Ac on block (i, i)
    joint_knot: torch.Tensor   # [nIter, ch] Δtᵢ at (i, jk(i))
    thr_knot: torch.Tensor     # [nIter, n_tk] Δtᵢ at (i, tk(i))
    static: torch.Tensor       # [26·nIter, n_var] +I on (i, i), −I on (i, i+1)


class _Rows(NamedTuple):
    """The rows that do not change from tick to tick, and their bounds."""

    init: torch.Tensor         # [26, n_var]
    throttle: torch.Tensor     # [n_throttle_constraints, n_var]
    joint: torch.Tensor        # [n_joint_position_constraints, n_var]
    v_min: torch.Tensor        # [] standardised throttle bounds
    v_max: torch.Tensor        # []
    q_min: torch.Tensor        # [n_ctrl] joint limits [rad]
    q_max: torch.Tensor        # [n_ctrl]


def _as(a, device, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _steps(cfg: MPCConfig, sched: HorizonSchedule, device, dtype) -> _Steps:
    """Made once on ``device``; read only for its callers."""
    ns, N = cfg.n_states, cfg.n_iter
    dts = np.asarray(sched.dts, np.float64)
    joint_knot = np.zeros((N, cfg.control_horizon))
    thr_knot = np.zeros((N, cfg.n_throttle_knots))
    static = np.zeros((cfg.n_dynamics_constraints, cfg.n_var))
    for i in range(N):
        joint_knot[i, sched.joint_knot_of_step[i]] = dts[i]
        thr_knot[i, sched.throttle_knot_of_step[i]] = dts[i]
        static[i * ns:(i + 1) * ns, i * ns:(i + 1) * ns] = np.eye(ns)
        static[i * ns:(i + 1) * ns, (i + 1) * ns:(i + 2) * ns] = -np.eye(ns)
    return _Steps(*(_as(a, device, dtype) for a in
                    (dts, np.diag(dts), joint_knot, thr_knot, static)))


@functools.lru_cache(maxsize=None)
def _rows(cfg: MPCConfig, device, dtype) -> _Rows:
    """Made once on ``device``; read only for its callers."""
    n, ns, nj, nt = cfg.n_var, cfg.n_states, cfg.n_ctrl_joints, cfg.n_jets
    init = np.zeros((ns, n))
    init[:, :ns] = np.eye(ns)
    thr = np.zeros((cfg.n_throttle_constraints, n))
    for i in range(cfg.n_throttle_knots):
        col = cfg.throttle_offset + i * nt
        thr[i * nt:(i + 1) * nt, col:col + nt] = np.eye(nt)
    joint = np.zeros((cfg.n_joint_position_constraints, n))
    for i in range(cfg.control_horizon if cfg.use_joint_position_constraint
                   else 0):
        col = cfg.joints_offset + i * nj
        joint[i * nj:(i + 1) * nj, col:col + nj] = np.eye(nj)
    t = functools.partial(_as, device=device, dtype=dtype)
    return _Rows(
        init=t(init), throttle=t(thr), joint=t(joint),
        v_min=jm.throttle_to_v(t(cfg.throttle_min)),
        v_max=jm.throttle_to_v(t(cfg.throttle_max)),
        q_min=t(np.deg2rad(cfg.joint_pos_min_deg)),
        q_max=t(np.deg2rad(cfg.joint_pos_max_deg)))


def _place(weights, blocks):
    """Block (i, j) = weights[i, j] · blocks[b], as [B, I·r, J·c]: an
    elementwise product, so a one-hot weight places a block exactly."""
    B, r, c = blocks.shape
    I, J = weights.shape
    return (weights[None, :, None, :, None] * blocks[:, None, :, None, :]
            ).reshape(B, I * r, J * c)


def build_dynamics_rows(cfg: MPCConfig, sched: HorizonSchedule, lin):
    """Forward-Euler multiple-shooting equalities [B, 26·nIter, n_var] +
    bounds. Row block i:  (I + Δtᵢ Ac) x_i − x_{i+1} + Δtᵢ BJ Δq_{jk(i)}
    + Δtᵢ BT v_{tk(i)} = −Δtᵢ c."""
    B = lin.Ac.shape[0]
    st = _steps(cfg, sched, lin.Ac.device, lin.Ac.dtype)
    blocks = torch.cat([
        _place(st.on_diag, lin.Ac),
        torch.zeros((B, cfg.n_dynamics_constraints, cfg.n_states),
                    dtype=lin.Ac.dtype, device=lin.Ac.device),
        _place(st.joint_knot, lin.BJ), _place(st.thr_knot, lin.BT)], dim=-1)
    bvec = (-st.dts[:, None] * lin.c[:, None, :]).reshape(B, -1)
    return st.static + blocks, bvec, bvec


def build_initial_state_rows(cfg: MPCConfig, x0):
    """x_0 = x̂ equality block."""
    A = _rows(cfg, x0.device, x0.dtype).init
    return A.expand(x0.shape[0], -1, -1), x0, x0


def build_throttle_rows(cfg: MPCConfig, pin_first_knot, throttle_cmd, dtype):
    """Throttle box/pin rows [B, 4·(nIter-ns+1), n_var] + bounds.

    Identity blocks on the throttle knots with [v(u_min), v(u_max)] bounds;
    where ``pin_first_knot`` [B] the first knot is clamped by equality to
    the applied throttle — the multi-rate hold. The remaining declared rows
    are zero rows with 0 ≤ 0 ≤ 0, as in the reference's sizing quirk
    (constraintsVSMPC.cpp:283 against :343)."""
    B = throttle_cmd.shape[0]
    rows = _rows(cfg, throttle_cmd.device, dtype)
    nt = cfg.n_jets
    n_rest = cfg.n_throttle_knots * nt - nt
    pad = torch.zeros((B, cfg.n_throttle_constraints - nt - n_rest),
                      dtype=dtype, device=throttle_cmd.device)
    v_applied = jm.throttle_to_v(throttle_cmd)
    pin = pin_first_knot[:, None]
    lb = torch.cat([torch.where(pin, v_applied, rows.v_min),
                    rows.v_min.expand(B, n_rest), pad], dim=-1)
    ub = torch.cat([torch.where(pin, v_applied, rows.v_max),
                    rows.v_max.expand(B, n_rest), pad], dim=-1)
    return rows.throttle.expand(B, -1, -1), lb, ub


def build_joint_position_rows(cfg: MPCConfig, joint_pos_ctrl, dtype):
    """Joint-position box rows [B, nJoints·nIter, n_var] + bounds.

    Per-knot identity on the joint-delta inputs bounded by the remaining
    range to the configured deg limits, measured from the current
    integrated joint position reference (constraintsVSMPC.cpp:434-456;
    nJoints·nIter rows are declared, rows past controlHorizon·nJoints stay
    0 ≤ 0 ≤ 0).

    Deliberate deviation, as the JAX package: the reference flips
    ``m_firstIteriation`` inside the knot loop (constraintsVSMPC.cpp:440-448),
    so only knot 0's identity block is ever written and knots 1..ch-1 are
    unconstrained. That looks like an upstream bug; every control knot is
    constrained here, strictly tighter and the constraint's evident intent
    (tests/golden_oracle.py mirrors the choice)."""
    B = joint_pos_ctrl.shape[0]
    rows = _rows(cfg, joint_pos_ctrl.device, dtype)
    ch = cfg.control_horizon
    pad = torch.zeros((B, cfg.n_joint_position_constraints
                       - ch * cfg.n_ctrl_joints), dtype=dtype,
                      device=joint_pos_ctrl.device)
    lb = torch.cat([(rows.q_min - joint_pos_ctrl).repeat(1, ch), pad], dim=-1)
    ub = torch.cat([(rows.q_max - joint_pos_ctrl).repeat(1, ch), pad], dim=-1)
    return rows.joint.expand(B, -1, -1), lb, ub


def assemble_constraints(cfg: MPCConfig, sched: HorizonSchedule, lin, x0,
                         pin_first_knot, throttle_cmd, joint_pos_ctrl=None):
    """Full [B, 512, 588] constraint stack + bounds, reference row order."""
    parts = [build_dynamics_rows(cfg, sched, lin),
             build_initial_state_rows(cfg, x0),
             build_throttle_rows(cfg, pin_first_knot, throttle_cmd, x0.dtype)]
    if cfg.use_joint_position_constraint:
        parts.append(build_joint_position_rows(cfg, joint_pos_ctrl, x0.dtype))
    A, lb, ub = (torch.cat(p, dim=-2 if k == 0 else -1)
                 for k, p in enumerate(zip(*parts)))
    return A, lb, ub
