"""Continuous-time linearised dynamics of the 26-state centroidal+jet model
(counterpart of ``ironcub_mpc_tpu/qp/blocks.py``).

ẋ = Ac x + BJ Δq + BT v + c, summed from the angular-momentum + RPY block,
the CoM + linear-momentum block and the jet second-order block. Momentum
states are in body coordinates; rows follow ``core.constants``. Snapshot
tensors carry a leading batch dimension B; :class:`LambdaInit` holds the
configure-time quantities shared by every lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import constants as C
from ..core.config import MPCConfig
from ..core.types import RobotSnapshot, const_tensor, index_tensor
from ..ops import jet_model as jm
from ..ops.so3 import euler_rate_matrix_inv, inv3, matrix_to_rpy, skew


class LinearizedDynamics(NamedTuple):
    Ac: torch.Tensor  # [B, 26, 26]
    BJ: torch.Tensor  # [B, 26, n_ctrl_joints]
    BT: torch.Tensor  # [B, 26, 4]
    c: torch.Tensor   # [B, 26]


class LambdaInit(NamedTuple):
    """Configure-time quantities of the 'constant' jointsLambdaOption and the
    RPY-error integrator reference (no batch dimension)."""

    rel_jac_lin: torch.Tensor     # [4,3,J] linear rows of relative jacobians at t0
    rel_jac_ang: torch.Tensor     # [4,3,J] angular rows of relative jacobians at t0
    jet_axes_world: torch.Tensor  # [4,3] jet axes at t0 (world)
    jet_arms_world: torch.Tensor  # [4,3] jet arms at t0 (world)
    rpy_init: torch.Tensor        # [3] base RPY at configure time


def _rows_to_body(vecs, R):
    """Each row v of ``vecs`` [..., 4, 3] to Rᵀv (``vecs @ R``)."""
    return vecs @ R


def lambda_lin(cfg: MPCConfig, snap: RobotSnapshot, init: LambdaInit,
               joint_sel) -> torch.Tensor:
    """Linear-momentum/joint coupling λ_lin [B, 3, n_ctrl]:
    λ = −Σᵢ Tᵢ S(Rᵀaᵢ) J_rel_ang,ᵢ, then the hard-coded arm-joint column
    slice ``[3, 3 + n_ctrl)`` of the reference."""
    R = snap.w_R_b
    if cfg.joints_lambda_option == "constant":
        axes, jac = init.jet_axes_world, init.rel_jac_ang
    else:  # "unfiltered"
        axes, jac = snap.jet_axes_world, snap.rel_jac_ang
    a_body = _rows_to_body(axes, R)                          # [B,4,3]
    terms = -snap.jet_thrusts[:, :, None, None] * (skew(a_body) @ jac)
    lam = terms.sum(dim=1)                                   # [B,3,J]
    return lam[:, :, 3:3 + cfg.n_ctrl_joints]


def lambda_ang(cfg: MPCConfig, snap: RobotSnapshot, init: LambdaInit,
               joint_sel) -> torch.Tensor:
    """Angular-momentum/joint coupling λ_ang [B, 3, n_ctrl]:
    −Tᵢ S(Rᵀaᵢ) J_relCoM,ᵢ − Tᵢ S(Rᵀrᵢ) S(Rᵀaᵢ) J_rel_ang,ᵢ per jet, columns
    picked by the name-based joint selector."""
    R = snap.w_R_b
    T = snap.jet_thrusts[:, :, None, None]
    if cfg.joints_lambda_option == "constant":
        a_body = _rows_to_body(init.jet_axes_world, R)
        r_body = _rows_to_body(init.jet_arms_world, R)
        terms = -T * (skew(a_body) @ init.rel_jac_lin
                      + skew(r_body) @ skew(a_body) @ init.rel_jac_ang)
        lam = terms.sum(dim=1)
    else:
        a_body = _rows_to_body(snap.jet_axes_world, R)
        r_body = _rows_to_body(snap.jet_arms_world, R)
        jac_rel_com = torch.einsum(
            "bca,bjcn->bjan", R,
            snap.jac_jets_lin_joints - snap.jac_com_joints[:, None])
        term1 = -T * (skew(a_body) @ jac_rel_com)
        term2 = -T * (skew(r_body) @ skew(a_body) @ snap.rel_jac_ang)
        lam = (term1 + term2).sum(dim=1)
    return lam[:, :, index_tensor(tuple(joint_sel), lam.device)]


def linearize(cfg: MPCConfig, snap: RobotSnapshot, init: LambdaInit,
              joint_sel, *, alpha_gravity, pos_com_ref_now,
              est_thrust_dot, thrust_des, thrust_dot_des,
              throttle_cmd) -> LinearizedDynamics:
    """Build the summed continuous-time system at the current state, one
    block-row band at a time."""
    R = snap.w_R_b
    B = R.shape[0]
    dt_, dev = R.dtype, R.device
    assert cfg.n_states == C.N_STATES, "block layout hard-codes the VSconstant order"
    nj = cfg.n_ctrl_joints

    omega_body = (R.mT @ snap.base_ang_vel_world[:, :, None])[:, :, 0]
    rpy = matrix_to_rpy(R)
    Winv = euler_rate_matrix_inv(rpy)
    S_omega = skew(omega_body)

    def z(r, cc):
        return torch.zeros((B, r, cc), dtype=dt_, device=dev)

    eye3 = torch.eye(3, dtype=dt_, device=dev).expand(B, 3, 3)
    eye4 = torch.eye(4, dtype=dt_, device=dev)

    def cat(*blocks):
        return torch.cat(blocks, dim=-1)

    # column layout [COM 3 | LIN 3 | RPY 3 | ANG 3 | T 4 | Ṫ 4 | PE 3 | RE 3]
    rows_com = cat(z(3, 3), R / snap.total_mass[:, None, None], z(3, 20))
    rows_lin = cat(z(3, 3), -S_omega, z(3, 6), snap.amom_jets_body[:, 0:3],
                   z(3, 10))
    rows_rpy = cat(z(3, 9), Winv @ inv3(snap.inertia_locked), z(3, 14))
    rows_ang = cat(z(3, 9), -S_omega, snap.amom_jets_body[:, 3:6], z(3, 10))
    rows_pe = cat(eye3, z(3, 23))
    rows_re = cat(z(3, 6), eye3, z(3, 17))

    gravity = const_tensor((0.0, 0.0, -9.81), dt_, dev)
    c_lin = (alpha_gravity[:, None] * snap.total_mass[:, None]
             * (R.mT @ gravity))

    if cfg.use_jet_dynamic:
        if cfg.use_estimated_thrust:
            T0, Td0 = snap.jet_thrusts, est_thrust_dot
        else:
            T0, Td0 = thrust_des, thrust_dot_des
        dh_dT = jm.dh_dthrust(T0, Td0, throttle_cmd)
        dh_dTd = jm.dh_dthrust_dot(T0, Td0, throttle_cmd)
        rows_T = cat(z(4, 16), eye4.expand(B, 4, 4), z(4, 6))
        rows_Td = cat(z(4, 12), dh_dT[:, :, None] * eye4,
                      dh_dTd[:, :, None] * eye4, z(4, 6))
        BT = torch.cat(
            [z(16, 4), jm.g_newton(thrust_des, thrust_dot_des)[:, :, None]
             * eye4, z(6, 4)], dim=-2)
        c_td = jm.f_newton(T0, Td0) - dh_dT * T0 - dh_dTd * Td0
    else:
        rows_T = z(4, 26)
        rows_Td = z(4, 26)
        BT = torch.cat([z(12, 4), eye4.expand(B, 4, 4), z(10, 4)], dim=-2)
        c_td = torch.zeros((B, 4), dtype=dt_, device=dev)

    Ac = torch.cat([rows_com, rows_lin, rows_rpy, rows_ang,
                    rows_T, rows_Td, rows_pe, rows_re], dim=-2)
    BJ = torch.cat(
        [z(3, nj), lambda_lin(cfg, snap, init, joint_sel), z(3, nj),
         lambda_ang(cfg, snap, init, joint_sel), z(14, nj)], dim=-2)
    zeros3 = torch.zeros((B, 3), dtype=dt_, device=dev)
    c = torch.cat(
        [zeros3, c_lin, zeros3, zeros3, torch.zeros((B, 4), dtype=dt_,
                                                    device=dev),
         c_td, -pos_com_ref_now, (-init.rpy_init).expand(B, 3)], dim=-1)
    return LinearizedDynamics(Ac, BJ, BT, c)
