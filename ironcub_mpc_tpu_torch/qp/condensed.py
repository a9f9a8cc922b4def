"""Condensed multi-rate MPC solve (counterpart of
``ironcub_mpc_tpu/qp/condensed.py``).

The states are eliminated exactly through the dynamics, leaving the box QP

    min_u  ½ uᵀ H_c u + q_cᵀ u    s.t.  lb ≤ u[box0:] ≤ ub

over u = [Δq_0..Δq_{ch-1} | v_0..v_{nk-1}] (120 inputs for the stock
config), solved by OSQP's ADMM scheme specialised to a selector constraint
matrix, with a carried (K(ρ))⁻¹ refreshed by Woodbury + Newton–Schulz and a
Schur-complement polish on the active box rows.

Every tensor carries a leading batch dimension B (one lane per scenario).
Where the JAX package decides per lane with ``lax.cond``, this module either
takes one batch-wide decision on the host (``settings.batch_guard``, the
``psum`` over the vmap axis) or computes both branches and joins them per
lane with ``torch.where`` (what ``lax.cond`` under ``vmap`` lowers to).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F_

from ..core import constants as C
from ..core.config import MPCConfig
from ..core.types import const_tensor, index_tensor
from ..horizon.schedule import HorizonSchedule
from ..ops import admm
from ..ops import jet_model as jm
from ..ops import kernels
from .blocks import LinearizedDynamics


class CondensedQP(NamedTuple):
    H: torch.Tensor        # [B, nU, nU]
    q: torch.Tensor        # [B, nU]
    lb: torch.Tensor       # [B, n_box] bounds on the box tail of u
    ub: torch.Tensor       # [B, n_box]
    F: torch.Tensor        # [B, nIter, 26, nU] state-from-input map
    f: torch.Tensor        # [B, nIter, 26] affine state response


class CondensedSolution(NamedTuple):
    u: torch.Tensor        # [B, nU]
    y: torch.Tensor        # [B, n_box] box duals
    states: torch.Tensor   # [B, nIter, 26] predicted states x_1..x_nIter
    status: torch.Tensor   # [B] int32
    pri_res: torch.Tensor  # [B]
    dua_res: torch.Tensor  # [B]
    kinv: torch.Tensor = None         # [B, nU, nU] (K(ρ))⁻¹ pre-polish
    rho_vec: torch.Tensor = None      # [B, n_box]
    rho_scalar: torch.Tensor = None   # [B]
    guard_fired: torch.Tensor = None  # [B] bool: kinv_guard re-factorised


class CondensedScaling(NamedTuple):
    """Frozen setup-time equilibration of the condensed QP."""

    D: torch.Tensor        # [nU] (or [B, nU]) symmetric diagonal scaling of H
    c: torch.Tensor        # [] (or [B]) cost scaling


def batch_any(flag: torch.Tensor) -> bool:
    """One batch-wide decision: ``flag.any()`` read on the host. Each call
    synchronises the host with the device; ``batch_any.syncs`` counts them."""
    batch_any.syncs += 1
    return bool(flag.any())


batch_any.syncs = 0


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _mv(A, v):
    """Batched mat-vec [B, m, n] @ [B, n] -> [B, m]."""
    return (A @ v[..., None])[..., 0]


def equilibrate(H, q, box0, iters):
    """Modified-Ruiz equilibration of the condensed KKT, per lane."""
    B, nU = H.shape[0], H.shape[-1]
    D = torch.ones((B, nU), dtype=H.dtype, device=H.device)
    c_s = torch.ones((B,), dtype=H.dtype, device=H.device)
    for _ in range(iters):
        d = admm._safe_inv_sqrt(H.abs().amax(dim=-2))
        # selector columns also carry a 1 in the stacked KKT matrix
        d[:, box0:] = admm._safe_inv_sqrt(
            torch.clamp_min(H[:, :, box0:].abs().amax(dim=-2), 1.0))
        H = d[:, :, None] * H * d[:, None, :]
        q = d * q
        D = D * d
        g = 1.0 / torch.clamp(torch.maximum(H.abs().amax(dim=-2).mean(dim=-1),
                                             q.abs().amax(dim=-1)), 1e-8, 1e8)
        H, q, c_s = g[:, None, None] * H, g[:, None] * q, c_s * g
    return H, q, CondensedScaling(D=D, c=c_s)


# explicit inverse of [B, n, n] by Gauss–Jordan, no pivoting, tiny pivots
# clamped to ±1e-12 (shared with the woodbury_ns twin)
_gj_inverse = kernels.gj_inverse


def n_inputs(cfg: MPCConfig) -> int:
    return (cfg.n_ctrl_joints * cfg.control_horizon
            + cfg.n_jets * cfg.n_throttle_knots)


def weighted_state_indices(cfg: MPCConfig):
    """Static indices of states with a nonzero tracking weight."""
    diag = np.zeros(cfg.n_states)
    diag[C.COM_POS] = cfg.weight_com_pos
    diag[C.LIN_MOM] = cfg.weight_lin_mom
    diag[C.RPY] = cfg.weight_rpy
    diag[C.ANG_MOM] = cfg.weight_ang_mom
    diag[C.POS_ERR] = cfg.weight_com_pos_error
    diag[C.RPY_ERR] = cfg.weight_rpy_error
    return tuple(int(i) for i in np.nonzero(diag)[0])


def n_box(cfg: MPCConfig) -> int:
    """Number of box-constrained inputs: the throttle tail, plus every
    joint-delta knot when the joint-position constraint is enabled."""
    nb = cfg.n_jets * cfg.n_throttle_knots
    if cfg.use_joint_position_constraint:
        nb += cfg.n_ctrl_joints * cfg.control_horizon
    return nb


def build_hu(cfg: MPCConfig) -> np.ndarray:
    """Constant input-space Hessian: joint-delta + joint-position
    regularisation per control knot, throttle-rate tridiagonal, initial
    throttle pull."""
    nU = n_inputs(cfg)
    nj, nt, ch = cfg.n_ctrl_joints, cfg.n_jets, cfg.control_horizon
    H = np.zeros((nU, nU))
    wj = np.diag(cfg.weight_delta_joint) + (
        cfg.weight_regularization_joint_pos * np.eye(nj))
    for i in range(ch):
        H[i * nj:(i + 1) * nj, i * nj:(i + 1) * nj] += wj
    to = nj * ch
    wt = cfg.weight_throttle * np.eye(nt)
    for i in range(ch - cfg.n_iter_small):
        a, b = to + i * nt, to + (i + 1) * nt
        H[a:a + nt, a:a + nt] += wt
        H[b:b + nt, b:b + nt] += wt
        H[a:a + nt, b:b + nt] -= wt
        H[b:b + nt, a:a + nt] -= wt
    H[to:to + nt, to:to + nt] += cfg.weight_initial_throttle * np.eye(nt)
    return H


class _InputMaps(NamedTuple):
    """Static one-hot maps of the inputs a step drives, over the nU input
    columns and an affine column nU."""

    joint: torch.Tensor    # [nIter, nj, nU+1]: Δq_{jk(k)} columns of step k
    throttle: torch.Tensor  # [nIter, nt, nU+1]: v_{tk(k)} columns
    affine: torch.Tensor   # [nU+1]: the affine-column selector
    dts: torch.Tensor      # [nIter]


@functools.lru_cache(maxsize=None)
def _input_maps(cfg: MPCConfig, sched: HorizonSchedule, device,
                dtype) -> _InputMaps:
    """Made once on ``device``; read only for its callers."""
    nU = n_inputs(cfg)
    nj, nt, ch, N = (cfg.n_ctrl_joints, cfg.n_jets, cfg.control_horizon,
                     cfg.n_iter)
    oh_j = np.zeros((N, nj, nU + 1))
    oh_t = np.zeros((N, nt, nU + 1))
    for k in range(N):
        jc = sched.joint_knot_of_step[k] * nj
        oh_j[k, :, jc:jc + nj] = np.eye(nj)
        tc = nj * ch + sched.throttle_knot_of_step[k] * nt
        oh_t[k, :, tc:tc + nt] = np.eye(nt)
    aff = np.zeros(nU + 1)
    aff[nU] = 1.0
    return _InputMaps(*(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in (oh_j, oh_t, aff,
                                  np.asarray(sched.dts, np.float64))))


def _step_panels(maps: _InputMaps, lin: LinearizedDynamics):
    """M̃_k = [Δt_k (BJ S_j,k + BT S_t,k) | Δt_k c] [B, nIter, 26, nU+1]:
    the one-hot products place each block exactly."""
    dts = maps.dts[:, None, None]
    M = dts * (lin.BJ[:, None] @ maps.joint + lin.BT[:, None] @ maps.throttle)
    return M + (dts * lin.c[:, None, :, None]) * maps.affine


def _assoc_chain(cfg: MPCConfig, sched: HorizonSchedule,
                 lin: LinearizedDynamics, x0):
    """Horizon-parallel condensing: the per-knot affine maps
    x_{k+1} = Ad_k x_k + (M_k u + Δt_k c) compose associatively —
    (A2,B2)∘(A1,B1) = (A2A1, A2B1+B2) — so the prefix compositions take
    ⌈log₂ nIter⌉ levels of batched [26,26] × [26,nU+1] products (a
    Hillis–Steele scan; XLA's ``associative_scan`` composes in another
    tree, so the rounding differs)."""
    nU = n_inputs(cfg)
    maps = _input_maps(cfg, sched, lin.Ac.device, lin.Ac.dtype)
    N = cfg.n_iter
    A_cum = _eye(cfg.n_states, lin.Ac) + maps.dts[:, None, None] * lin.Ac[:, None]
    B_cum = _step_panels(maps, lin)
    s = 1
    while s < N:
        A_later = A_cum[:, s:]
        A_cum = torch.cat([A_cum[:, :s], A_later @ A_cum[:, :N - s]], dim=1)
        B_cum = torch.cat([B_cum[:, :s],
                           A_later @ B_cum[:, :N - s] + B_cum[:, s:]], dim=1)
        s *= 2
    f_all = (A_cum @ x0[:, None, :, None])[..., 0] + B_cum[..., nU]
    return B_cum[..., :nU], f_all


def _mat3(M, X):
    """[B,3,3] @ [B,3,W] as a broadcast multiply and a 3-term sum."""
    return (M[:, :, :, None] * X[:, None, :, :]).sum(dim=2)


def _structured_chain(cfg: MPCConfig, sched: HorizonSchedule,
                      lin: LinearizedDynamics, x0):
    """Exact state propagation exploiting Ac's block structure.

    The 26-state transition is ~85% structural zeros: the only genuinely
    recursive states are the two momenta (3-dim each, coupled to themselves
    by −S(ω)) and the per-jet (T, Ṫ) pairs (decoupled 2-dim systems).
    Everything else integrates them: CoM integrates R/m·h_lin, RPY
    integrates W⁻¹I⁻¹·h_ω, the error states integrate CoM/RPY — prefix
    sums, not chains. So the chain shrinks to elementwise updates on
    [3, nU+1] / [4, nU+1] panels, with every coupling and prefix sum
    computed for all steps at once. The affine response f rides as column
    nU of each panel."""
    if not cfg.use_jet_dynamic:
        raise ValueError("structured condensing needs the jet chain")
    nU = n_inputs(cfg)
    ac, B_ = lin.Ac, lin.Ac.shape[0]
    maps = _input_maps(cfg, sched, ac.device, ac.dtype)
    aff = maps.affine
    N = cfg.n_iter

    def init_panel(rows):
        p = torch.zeros((B_, rows.stop - rows.start, nU + 1), dtype=ac.dtype,
                        device=ac.device)
        p[:, :, nU] = x0[:, rows]
        return p

    def diag(M):
        return torch.diagonal(M, dim1=-2, dim2=-1)

    # --- jet subchain: per-jet (T, Ṫ) pairs, all elementwise ---------------
    d1 = diag(ac[:, C.THRUST_DOT, C.THRUST])[:, :, None]        # [B,4,1]
    d2 = diag(ac[:, C.THRUST_DOT, C.THRUST_DOT])[:, :, None]
    g_eff = diag(lin.BT[:, C.THRUST_DOT])                       # [B,4]
    c_td = lin.c[:, C.THRUST_DOT]
    U_T = (g_eff[:, None, :, None] * maps.throttle
           + c_td[:, None, :, None] * aff)                      # [B,N,4,W]
    T0, Td0 = init_panel(C.THRUST), init_panel(C.THRUST_DOT)
    T, Td, T_seq, Td_seq = T0, Td0, [], []
    for k in range(N):
        dtk = maps.dts[k]
        T, Td = T + dtk * Td, Td + dtk * (d1 * T + d2 * Td + U_T[:, k])
        T_seq.append(T)
        Td_seq.append(Td)
    T_seq, Td_seq = torch.stack(T_seq, 1), torch.stack(Td_seq, 1)
    T_pre = torch.cat([T0[:, None], T_seq[:, :-1]], dim=1)     # [B,N,4,W]

    # --- momentum subchains: 3-dim, coupled to themselves by −S(ω) ---------
    def coupled(rows):
        return (torch.einsum("bij,bkjw->bkiw", ac[:, rows, C.THRUST], T_pre)
                + torch.einsum("bij,kjw->bkiw", lin.BJ[:, rows], maps.joint)
                + lin.c[:, rows][:, None, :, None] * aff)       # [B,N,3,W]

    V_lm, V_am = coupled(C.LIN_MOM), coupled(C.ANG_MOM)
    S_lm, S_am = ac[:, C.LIN_MOM, C.LIN_MOM], ac[:, C.ANG_MOM, C.ANG_MOM]
    lm0, am0 = init_panel(C.LIN_MOM), init_panel(C.ANG_MOM)
    lm, am, lm_seq, am_seq = lm0, am0, [], []
    for k in range(N):
        dtk = maps.dts[k]
        lm = lm + dtk * (_mat3(S_lm, lm) + V_lm[:, k])
        am = am + dtk * (_mat3(S_am, am) + V_am[:, k])
        lm_seq.append(lm)
        am_seq.append(am)
    lm_seq, am_seq = torch.stack(lm_seq, 1), torch.stack(am_seq, 1)
    lm_pre = torch.cat([lm0[:, None], lm_seq[:, :-1]], dim=1)
    am_pre = torch.cat([am0[:, None], am_seq[:, :-1]], dim=1)

    # --- integrator states: prefix sums over the horizon -------------------
    d = maps.dts[:, None, None]

    def integrate(gain, src_pre, rows):
        inc = d * (torch.einsum("bij,bkjw->bkiw", gain, src_pre)
                   + lin.c[:, rows][:, None, :, None] * aff)
        return torch.cumsum(inc, dim=1) + init_panel(rows)[:, None]

    com_seq = integrate(ac[:, C.COM_POS, C.LIN_MOM], lm_pre, C.COM_POS)
    rpy_seq = integrate(ac[:, C.RPY, C.ANG_MOM], am_pre, C.RPY)
    eye3 = _eye(3, ac).expand(B_, 3, 3)
    com_pre = torch.cat([init_panel(C.COM_POS)[:, None], com_seq[:, :-1]], 1)
    rpy_pre = torch.cat([init_panel(C.RPY)[:, None], rpy_seq[:, :-1]], 1)
    pe_seq = integrate(eye3, com_pre, C.POS_ERR)
    re_seq = integrate(eye3, rpy_pre, C.RPY_ERR)

    panels = torch.cat([com_seq, lm_seq, rpy_seq, am_seq, T_seq, Td_seq,
                        pe_seq, re_seq], dim=2)                # [B,N,26,W]
    return panels[..., :nU], panels[..., nU]


def _paired_chain(cfg: MPCConfig, sched: HorizonSchedule,
                  lin: LinearizedDynamics, x0):
    """Exact chain with half the sequential depth: consecutive steps share
    Ac, so a pair collapses to one matrix,
    Ad_{k+1}·Ad_k = I + (Δt_k+Δt_{k+1})Ac + Δt_k·Δt_{k+1}·Ac². The chain
    runs ⌈N/2⌉ [26,26]@[26,nU+1] products over the even knots, and every
    odd (and a trailing final) knot is recovered afterwards in one batched
    product. f rides as the affine column."""
    ns, nU, N = cfg.n_states, n_inputs(cfg), cfg.n_iter
    ac = lin.Ac
    maps = _input_maps(cfg, sched, ac.device, ac.dtype)
    eye = _eye(ns, ac)
    Mt = _step_panels(maps, lin)                               # [B,N,26,W]

    n_pairs = N // 2
    a = maps.dts[0:2 * n_pairs:2][:, None, None]
    b = maps.dts[1:2 * n_pairs:2][:, None, None]
    Ac2 = ac @ ac
    Ad2 = eye + (a + b) * ac[:, None] + (a * b) * Ac2[:, None]  # [B,P,26,26]
    Ad_odd = eye + b * ac[:, None]
    M2 = Ad_odd @ Mt[:, 0:2 * n_pairs:2] + Mt[:, 1:2 * n_pairs:2]

    F0 = torch.zeros((ac.shape[0], ns, nU + 1), dtype=ac.dtype,
                     device=ac.device)
    F0[..., nU] = x0
    Ft, evens = F0, []
    for p in range(n_pairs):
        Ft = Ad2[:, p] @ Ft + M2[:, p]                         # F̃_(2p+2)
        evens.append(Ft)

    # recover the odd knots (and the final knot when N is odd) in one batch:
    # F̃_(2p+1) = Ad_(2p) F̃_(2p) + M̃_(2p); F̃_(N) = Ad_(N-1) F̃_(N-1) + M̃_(N-1)
    rec_steps = list(range(0, 2 * n_pairs, 2))
    rec_prev = [F0] + evens[:-1]
    if N % 2 == 1:
        rec_steps.append(N - 1)
        rec_prev.append(evens[-1])
    steps = index_tensor(tuple(rec_steps), ac.device)
    Ad_rec = eye + maps.dts[steps][:, None, None] * ac[:, None]
    rec = Ad_rec @ torch.stack(rec_prev, 1) + Mt[:, steps]    # odd (+ final)

    panels = []
    for p in range(n_pairs):
        panels += [rec[:, p], evens[p]]                        # F̃_(2p+1), (2p+2)
    if N % 2 == 1:
        panels.append(rec[:, n_pairs])                         # F̃_(N)
    stacked = torch.stack(panels, 1)                           # [B,N,26,W]
    return stacked[..., :nU], stacked[..., nU]


def _sequential_chain(cfg: MPCConfig, sched: HorizonSchedule,
                      lin: LinearizedDynamics, x0):
    """The forward chain: F_{k+1} = Ad_k F_k + M_k, f_{k+1} = Ad_k f_k +
    Δt_k c."""
    ns, nU = cfg.n_states, n_inputs(cfg)
    nj, nt, ch = cfg.n_ctrl_joints, cfg.n_jets, cfg.control_horizon
    Ac = lin.Ac
    B = Ac.shape[0]
    dt_, dev = Ac.dtype, Ac.device
    eye = _eye(ns, Ac)
    Fs, fs = [], []
    F = torch.zeros((B, ns, nU), dtype=dt_, device=dev)
    f = x0
    for k in range(cfg.n_iter):
        dtk = sched.dts[k]
        Ad = eye + dtk * Ac
        Mk = torch.zeros((B, ns, nU), dtype=dt_, device=dev)
        jc = sched.joint_knot_of_step[k] * nj
        Mk[:, :, jc:jc + nj] = dtk * lin.BJ
        tc = nj * ch + sched.throttle_knot_of_step[k] * nt
        Mk[:, :, tc:tc + nt] = dtk * lin.BT
        F = Ad @ F + Mk
        f = _mv(Ad, f) + dtk * lin.c
        Fs.append(F)
        fs.append(f)
    return torch.stack(Fs, dim=1), torch.stack(fs, dim=1)


def condense(cfg: MPCConfig, sched: HorizonSchedule, lin: LinearizedDynamics,
             x0, state_reference, q_diag, H_u, joint_reg_grad,
             throttle_init_grad, pin_first_knot, throttle_cmd,
             joint_pos_ctrl=None) -> CondensedQP:
    """Propagate the discrete dynamics and fold the tracking cost into u:
    x_{k+1} = (I + Δt_k Ac) x_k + Δt_k (BJ Δq_{jk(k)} + BT v_{tk(k)} + c),
    H_c = Σ F_kᵀ Q F_k + H_u,  q_c = Σ F_kᵀ Q (f_k − r_k) + q_u. The
    chain (F_k, f_k) is built per ``cfg.condense_mode``: "sequential",
    "assoc", "structured" or "paired" (without jet dynamics "structured"
    is the sequential chain)."""
    if cfg.condense_mode == "assoc":
        F_all, f_all = _assoc_chain(cfg, sched, lin, x0)
    elif cfg.condense_mode == "structured" and cfg.use_jet_dynamic:
        F_all, f_all = _structured_chain(cfg, sched, lin, x0)
    elif cfg.condense_mode == "paired":
        F_all, f_all = _paired_chain(cfg, sched, lin, x0)
    elif cfg.condense_mode in ("sequential", "structured"):
        F_all, f_all = _sequential_chain(cfg, sched, lin, x0)
    else:
        raise ValueError(
            f"unknown condense_mode {cfg.condense_mode!r}; "
            "expected 'assoc', 'sequential', 'structured' or 'paired'")
    nj, nt, ch = cfg.n_ctrl_joints, cfg.n_jets, cfg.control_horizon
    B, dt_, dev = x0.shape[0], x0.dtype, x0.device
    r = state_reference.mT                     # [B, nIter, 26]
    # contract only over weighted states (a static gather)
    w_idx = index_tensor(weighted_state_indices(cfg), dev)
    Fw = F_all[:, :, w_idx, :]
    qw = q_diag[w_idx]
    G = (Fw * qw[:, None]).flatten(1, 2)       # [B, nIter·nw, nU]
    H = G.mT @ Fw.flatten(1, 2) + H_u
    q = _mv(G.mT, (f_all - r)[:, :, w_idx].flatten(1, 2))
    q[:, :nj * ch] += joint_reg_grad.repeat(1, ch)
    q[:, nj * ch:nj * ch + nt] += throttle_init_grad

    v_min = jm.throttle_to_v(const_tensor(cfg.throttle_min, dt_, dev))
    v_max = jm.throttle_to_v(const_tensor(cfg.throttle_max, dt_, dev))
    v_applied = jm.throttle_to_v(throttle_cmd)
    nbt = nt * cfg.n_throttle_knots
    lb_t = v_min.expand(B, nbt).clone()
    ub_t = v_max.expand(B, nbt).clone()
    pin = pin_first_knot[:, None]
    lb_t[:, :nt] = torch.where(pin, v_applied, lb_t[:, :nt])
    ub_t[:, :nt] = torch.where(pin, v_applied, ub_t[:, :nt])
    if cfg.use_joint_position_constraint:
        q_min = const_tensor(
            tuple(np.deg2rad(cfg.joint_pos_min_deg).tolist()), dt_, dev)
        q_max = const_tensor(
            tuple(np.deg2rad(cfg.joint_pos_max_deg).tolist()), dt_, dev)
        lb = torch.cat([(q_min - joint_pos_ctrl).repeat(1, ch), lb_t], dim=-1)
        ub = torch.cat([(q_max - joint_pos_ctrl).repeat(1, ch), ub_t], dim=-1)
    else:
        lb, ub = lb_t, ub_t
    return CondensedQP(H=H, q=q, lb=lb, ub=ub, F=F_all, f=f_all)


def _k_matrix(H, sigma, box0, rho_box):
    """K = (H + σI) + diag(0 | ρ), added in that order."""
    zeros = torch.zeros_like(rho_box[:, :1]).expand(-1, box0)
    K = H + torch.diag_embed(torch.full_like(H[:, 0], sigma))
    return K + torch.diag_embed(torch.cat([zeros, rho_box], dim=-1))


def _inverse_by_cholesky(K):
    """(K)⁻¹ by Cholesky and two triangular solves; a lane whose K is not
    positive definite gets NaN, as XLA's Cholesky gives."""
    L, info = torch.linalg.cholesky_ex(K)
    eye = _eye(K.shape[-1], K).expand_as(K)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Kinv = torch.linalg.solve_triangular(L.mT, Linv, upper=True)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(Kinv, float("nan")), Kinv)


def setup(cfg: MPCConfig, qp: CondensedQP, settings: admm.ADMMSettings):
    """One-time solver setup from the configure-time QP: frozen
    equilibration plus the only exact factorisation of the run. Returns
    ``(scaling, kinv0, rho_vec0, rho_scalar0)``, each with the batch
    dimension of ``qp``."""
    nU = qp.H.shape[-1]
    nb = qp.lb.shape[-1]
    box0 = nU - nb
    H, _, scaling = equilibrate(qp.H, qp.q, box0, settings.scaling_iters)
    E = 1.0 / scaling.D[:, box0:]
    lb, ub = E * qp.lb, E * qp.ub
    eq = (ub - lb) < settings.eq_tol
    rho_scalar = torch.full_like(scaling.c, settings.rho)
    rho_vec = torch.where(eq, rho_scalar[:, None] * settings.rho_eq_scale,
                          rho_scalar[:, None])
    kinv = _inverse_by_cholesky(_k_matrix(H, settings.sigma, box0, rho_vec))
    return scaling, kinv, rho_vec, rho_scalar


def solve(cfg: MPCConfig, qp: CondensedQP,
          settings: admm.ADMMSettings, warm_u=None, warm_y=None,
          scaling: CondensedScaling = None, kinv_prev=None, rho_prev=None,
          rho_scalar_prev=None) -> CondensedSolution:
    """Box-constrained ADMM with selector structure + Schur polish, per
    lane. With ``kinv_prev``/``rho_prev`` and a frozen ``scaling`` the
    carried (K(ρ))⁻¹ is refreshed by a rank-n_box Woodbury update plus
    Newton–Schulz instead of a fresh Cholesky."""
    B, nU = qp.H.shape[0], qp.H.shape[-1]
    nb = qp.lb.shape[-1]
    box0 = nU - nb
    dt_, dev = qp.H.dtype, qp.H.device
    s = settings
    bg = s.batch_guard

    if scaling is None:
        H, q, scaling = equilibrate(qp.H, qp.q, box0, s.scaling_iters)
        D, c_s = scaling.D, scaling.c
    else:
        D = scaling.D.expand(B, nU)
        c_s = scaling.c.reshape(-1).expand(B)
        H = c_s[:, None, None] * (D[:, :, None] * qp.H * D[:, None, :])
        q = c_s[:, None] * (D * qp.q)
    E = 1.0 / D[:, box0:]
    lb, ub = E * qp.lb, E * qp.ub

    eq = (ub - lb) < s.eq_tol
    rho_default = torch.full((B,), s.rho, dtype=dt_, device=dev)
    rho_scalar0 = rho_default if rho_scalar_prev is None else rho_scalar_prev
    # a non-solved tick may carry non-finite solver state; never let it
    # poison the next tick
    rho_scalar0 = torch.where(torch.isfinite(rho_scalar0) & (rho_scalar0 > 0),
                              rho_scalar0, rho_default)

    def rho_pattern(rho_scalar):
        return torch.where(eq, rho_scalar[:, None] * s.rho_eq_scale,
                           rho_scalar[:, None])

    rho0 = rho_pattern(rho_scalar0)

    def factor(rho_vec):
        return _inverse_by_cholesky(_k_matrix(H, s.sigma, box0, rho_vec))

    def ns_polish(Kinv_l, rho_new, n_ns):
        """Newton–Schulz against K built from the current H, then
        symmetrise."""
        if n_ns:
            K = _k_matrix(H, s.sigma, box0, rho_new)
            eye = _eye(nU, H)
            for _ in range(n_ns):
                Kinv_l = Kinv_l @ (2.0 * eye - K @ Kinv_l)
        return 0.5 * (Kinv_l + Kinv_l.mT)

    def woodbury(Kinv, rho_old, rho_new, n_ns=s.ns_steps):
        """(K(ρ_new))⁻¹ from (K(ρ_old))⁻¹ in the unpadded box layout."""
        d = rho_new - rho_old
        M = _eye(nb, H) + d[:, :, None] * Kinv[:, box0:, box0:]
        Bm = d[:, :, None] * Kinv[:, box0:, :]
        if nb <= 32:
            X = _gj_inverse(M) @ Bm
        else:
            X = torch.linalg.solve(M, Bm)
        Knew = Kinv - Kinv[:, :, box0:] @ X
        return ns_polish(Knew, rho_new, n_ns)

    x = (torch.zeros((B, nU), dtype=dt_, device=dev) if warm_u is None
         else warm_u / D)
    y = (torch.zeros((B, nb), dtype=dt_, device=dev) if warm_y is None
         else warm_y * c_s[:, None] / E)
    # warm starts come from the previous tick even when it did not solve
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    y = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
    z = torch.clamp(x[:, box0:], lb, ub)

    def run_segment(Kinv, rho_vec, x, z, y, length):
        for _ in range(length):
            rhs = s.sigma * x - q
            rhs = torch.cat([rhs[:, :box0], rhs[:, box0:] + (rho_vec * z - y)],
                            dim=-1)
            x_t = _mv(Kinv, rhs)
            z_t = x_t[:, box0:]
            x_n = s.alpha * x_t + (1 - s.alpha) * x
            z_rel = s.alpha * z_t + (1 - s.alpha) * z
            z_un = z_rel + y / rho_vec
            z_n = torch.clamp(z_un, lb, ub)
            y = rho_vec * (z_un - z_n)
            x, z = x_n, z_n
        return x, z, y

    # --- hand-written kernels on the padded full layout (ops/kernels) ----
    if admm.kernels_enabled(s):
        P = kernels._pad_to(nU)

        def lift(A):                           # [B, nU, nU] -> [B, P, P]
            return F_.pad(A, (0, P - nU, 0, P - nU))

        def lower(Ap):
            return Ap[:, :nU, :nU]

        def pv_box(vb, fill=0.0):              # box layout -> [B, P]
            out = torch.full((B, P), fill, dtype=dt_, device=dev)
            out[:, box0:nU] = vb
            return out

        H_p = lift(H).contiguous()
        q_f = F_.pad(q, (0, P - nU)).contiguous()
        lb_f = pv_box(lb, -s.inf_bound)
        lb_f[:, nU:] = 0.0
        ub_f = pv_box(ub, s.inf_bound)
        ub_f[:, nU:] = 0.0

        def woodbury_k(Kinv_p, rho_old, rho_new, n_ns=s.ns_steps):
            return kernels.woodbury_ns(
                Kinv_p.contiguous(), H_p, pv_box(rho_new - rho_old),
                pv_box(rho_new), box0=box0, n_box=nb, sigma=s.sigma,
                n_ns=n_ns)

        def run_segment_k(Kinv_p, rho_vec, x, z, y, length):
            xf, zf, yf = kernels.admm_segment(
                Kinv_p.contiguous(), q_f, lb_f, ub_f, pv_box(rho_vec),
                pv_box(1.0 / rho_vec), F_.pad(x, (0, P - nU)).contiguous(),
                pv_box(z), pv_box(y), sigma=s.sigma, alpha=s.alpha,
                length=length)
            return xf[:, :nU], zf[:, box0:nU], yf[:, box0:nU]
    else:
        def lift(A):
            return A

        lower = lift
        woodbury_k, run_segment_k = woodbury, run_segment

    def residuals(x, z, y):
        pri = ((x[:, box0:] - z) / E).abs().amax(dim=-1)
        Hx = _mv(H, x)
        grad = Hx + q
        grad = torch.cat([grad[:, :box0], grad[:, box0:] + y], dim=-1)
        dua = (grad / D).abs().amax(dim=-1) / c_s
        pri_s = torch.maximum((x[:, box0:] / E).abs().amax(dim=-1),
                              (z / E).abs().amax(dim=-1))
        dua_s = (Hx / D).abs().amax(dim=-1) / c_s
        return pri, dua, pri_s, dua_s

    # three fixed probes; the third is supported on the box coordinates only
    probes = torch.zeros((nU, 3), dtype=dt_, device=dev)
    probes[:, 0] = 1.0
    probes[1::2, 0] = -1.0
    probes[:, 1] = torch.linspace(-1.0, 1.0, nU, dtype=dt_, device=dev)
    probes[box0:, 2] = 1.0
    probes[box0 + 1::2, 2] = -1.0

    def kinv_probe_resid(Kinv_l, rho_v):
        """max over the probes v of ‖K(ρ)·(K⁻¹ v) − v‖∞, a lower bound on
        the inverse residual at mat-vec cost."""
        Xv = Kinv_l @ probes                          # [B, nU, 3]
        KXv = H @ Xv + s.sigma * Xv
        KXv = torch.cat([KXv[:, :box0],
                         KXv[:, box0:] + rho_v[:, :, None] * Xv[:, box0:]],
                        dim=1)
        return (KXv - probes).abs().amax(dim=(-2, -1))

    def pick(mask, a, b):
        """Per-lane select between two batched tensors."""
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    marks = [i for i in s.rho_update_iters if i < s.max_iter]
    bounds = [0] + marks + [s.max_iter]
    rho_scalar = rho_scalar0
    rho_vec = rho0
    guard_fired = torch.zeros((B,), dtype=torch.bool, device=dev)
    if kinv_prev is None:
        Kinv = lift(factor(rho_vec))
    else:
        # refresh the carried inverse: exact rank-n_box correction for the
        # ρ pattern change and Newton–Schulz against the current H
        kp = torch.where(torch.isfinite(kinv_prev), kinv_prev,
                         torch.zeros_like(kinv_prev))
        rp = torch.where(torch.isfinite(rho_prev) & (rho_prev > 0),
                         rho_prev, rho_vec)

        def with_resid(k_p):
            if s.kinv_guard:
                return k_p, kinv_probe_resid(lower(k_p), rho_vec)
            return k_p, torch.zeros((B,), dtype=dt_, device=dev)

        resid = None
        if not bg:
            if s.ns_skip_tol > 0:
                r0 = kinv_probe_resid(kp, rho_vec)
                stale = ~torch.isfinite(r0) | (r0 > s.ns_skip_tol)
                k_w, r_w = with_resid(woodbury_k(lift(kp), rp, rho_vec))
                Kinv = pick(stale, k_w, lift(kp))
                resid = torch.where(stale, r_w, r0)
            else:
                Kinv = woodbury_k(lift(kp), rp, rho_vec)
        else:
            # batch-wide: the rank-n_box correction runs for every lane
            # when any lane's ρ moved; otherwise the drift-absorbing NS
            # polish runs unless every lane's probe is inside ns_skip_tol
            if batch_any((rho_vec - rp).abs() > 0):
                Kinv, resid = with_resid(woodbury_k(lift(kp), rp, rho_vec))
            elif s.ns_skip_tol > 0:
                r0 = kinv_probe_resid(kp, rho_vec)
                if batch_any(~torch.isfinite(r0) | (r0 > s.ns_skip_tol)):
                    Kinv, resid = with_resid(
                        lift(ns_polish(kp, rho_vec, s.ns_steps)))
                else:
                    Kinv, resid = lift(kp), r0
            else:
                Kinv, resid = with_resid(
                    lift(ns_polish(kp, rho_vec, s.ns_steps)))
        if s.kinv_guard:
            # Newton–Schulz only contracts from ‖I − K·X‖ < 1: re-factorise
            # a lane whose refreshed inverse fails the probe
            if resid is None:
                resid = kinv_probe_resid(lower(Kinv), rho_vec)
            bad = ~torch.isfinite(resid) | (resid > 0.1)
            guard_fired = bad
            if not bg or batch_any(bad):
                Kinv = pick(bad, lift(factor(rho_vec)), Kinv)

    def converged(x, z, y):
        pri, dua, pri_s, dua_s = residuals(x, z, y)
        return ((pri <= s.eps_abs + s.eps_rel * pri_s)
                & (dua <= s.eps_abs + s.eps_rel * dua_s))

    def run_segment_early(Kinv, rho_vec, x, z, y, length, global_pos):
        """term_check_every-chunked segment; a chunk is skipped once every
        lane (batch_guard) or the lane itself has converged. The first
        chunk of the solve always runs."""
        ce = s.term_check_every
        if ce <= 0:
            return run_segment_k(Kinv, rho_vec, x, z, y, length)
        pos = 0
        while pos < length:
            n = min(ce, length - pos)
            if global_pos + pos == 0:
                x, z, y = run_segment_k(Kinv, rho_vec, x, z, y, n)
            else:
                todo = ~converged(x, z, y)
                if bg:
                    if batch_any(todo):
                        x, z, y = run_segment_k(Kinv, rho_vec, x, z, y, n)
                else:
                    xn, zn, yn = run_segment_k(Kinv, rho_vec, x, z, y, n)
                    x, z, y = (pick(todo, xn, x), pick(todo, zn, z),
                               pick(todo, yn, y))
            pos += n
        return x, z, y

    for si in range(len(bounds) - 1):
        x, z, y = run_segment_early(Kinv, rho_vec, x, z, y,
                                    bounds[si + 1] - bounds[si], bounds[si])
        if si < len(bounds) - 2:
            pri, dua, pri_s, dua_s = residuals(x, z, y)
            ratio = torch.sqrt(
                (pri / torch.clamp_min(pri_s, 1e-12))
                / torch.clamp_min(dua / torch.clamp_min(dua_s, 1e-12), 1e-12))
            upd = (ratio > s.adaptive_rho_tolerance) | (
                ratio < 1.0 / s.adaptive_rho_tolerance)
            if s.term_check_every > 0:
                # a converged lane keeps its ρ (OSQP never re-tunes after
                # termination)
                done_here = ((pri <= s.eps_abs + s.eps_rel * pri_s)
                             & (dua <= s.eps_abs + s.eps_rel * dua_s))
                upd = upd & ~done_here
            rho_scalar = torch.where(
                upd, torch.clamp(rho_scalar * ratio, s.rho_min, s.rho_max),
                rho_scalar)
            rho_new = pick(upd, rho_pattern(rho_scalar), rho_vec)
            if not bg or batch_any(upd):
                Kinv = woodbury_k(Kinv, rho_vec, rho_new)
            rho_vec = rho_new

    kinv_out, rho_out, rho_scalar_out = lower(Kinv), rho_vec, rho_scalar

    # --- Schur polish on the active box set -------------------------------
    if s.polish:
        delta = s.delta_polish
        low = (y < 0) | eq
        up = (y > 0) | eq
        active = (low | up).to(dt_)
        b_act = torch.where(y < 0, lb, ub)
        b_act = torch.where(eq, ub, b_act)
        # (H + δI + SᵀaSa/δ) x = −q + Sᵀa b/δ
        rhs = torch.cat([-q[:, :box0], -q[:, box0:] + active * b_act / delta],
                        dim=-1)
        if s.delta_polish == s.sigma:
            # G = K + Sᵀ(active/δ − ρ)S: a Woodbury refresh of the iteration
            # inverse
            Ginv = lower(woodbury_k(Kinv, rho_vec, active / delta,
                                    s.polish_ns_steps))

            def g_apply(v):
                Gv = _mv(H, v) + delta * v
                return torch.cat([Gv[:, :box0],
                                  Gv[:, box0:] + active * v[:, box0:] / delta],
                                 dim=-1)

            x_p = _mv(Ginv, rhs)
            for _ in range(s.polish_refine_iters):
                x_p = x_p + _mv(Ginv, rhs - g_apply(x_p))
        else:
            G = _k_matrix(H, delta, box0, active / delta)
            cholG = torch.linalg.cholesky_ex(G)[0]
            x_p = torch.cholesky_solve(rhs[..., None], cholG)[..., 0]
            for _ in range(s.polish_refine_iters):
                r = rhs - _mv(G, x_p)
                x_p = x_p + torch.cholesky_solve(r[..., None], cholG)[..., 0]
        y_p = torch.where(active > 0, (x_p[:, box0:] - b_act) / delta,
                          torch.zeros_like(b_act))
        z_p = torch.clamp(x_p[:, box0:], lb, ub)
        p0, d0, _, _ = residuals(x, z, y)
        p1, d1, _, _ = residuals(x_p, z_p, y_p)
        better = (p1 + d1) < (p0 + d0)
        x, z, y = pick(better, x_p, x), pick(better, z_p, z), pick(better, y_p, y)

    pri, dua, pri_s, dua_s = residuals(x, z, y)
    solved = ((pri <= s.eps_abs + s.eps_rel * pri_s)
              & (dua <= s.eps_abs + s.eps_rel * dua_s))
    inacc = ((pri <= 10 * (s.eps_abs + s.eps_rel * pri_s))
             & (dua <= 10 * (s.eps_abs + s.eps_rel * dua_s)))
    status = torch.where(
        solved, admm.SOLVED,
        torch.where(inacc, admm.SOLVED_INACCURATE, admm.MAX_ITER_REACHED))
    u = x * D
    states = (qp.F @ u[:, None, :, None])[..., 0] + qp.f
    return CondensedSolution(
        u=u, y=y * E / c_s[:, None], states=states,
        status=status.to(torch.int32), pri_res=pri, dua_res=dua,
        kinv=kinv_out, rho_vec=rho_out, rho_scalar=rho_scalar_out,
        guard_fired=guard_fired)
