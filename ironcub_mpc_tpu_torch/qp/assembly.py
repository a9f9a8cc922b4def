"""The parts of ``ironcub_mpc_tpu/qp/assembly.py`` that the condensed tick
uses: the state weight, the constant full-space Hessian (numpy, built once
at configure) and the per-knot state reference."""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.config import MPCConfig
from ..core.types import index_tensor


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
