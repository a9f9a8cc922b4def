"""Floating-base kinodynamics (counterpart of
``ironcub_mpc_tpu/dynamics/kinodynamics.py``).

Mass matrix, centroidal momentum (+ matrix), CoM (+ Jacobian), per-frame and
base-relative Jacobians, jet allocation matrices and the bias forces of the
plant, in one **common-frame (world-origin Plücker) formulation**: forward
kinematics gives every link pose, each link gets a 6×(6+n) spatial Jacobian
at the world origin from static path masks, and every aggregate is a batched
contraction over links:

- mass matrix ``Σ_k J_kᵀ I_k J_k``, momentum ``Σ_k I_k J_k ν``,
- bias forces ``Σ_k J_kᵀ (I_k Ā_k + V_k ×* I_k V_k)`` with the gravity trick
  folded into ``Ā_k``.

Generalised velocity = iDynTree MIXED: ν = [v_base_origin (world); ω_base
(world); q̇]; spatial vectors are ordered [linear; angular]. Every state
argument and every result carries a leading batch dimension B (one lane per
scenario) where the JAX package is ``vmap``-ed; shapes in the docstrings are
per lane.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.types import RobotSnapshot, const_tensor
from ..ops.so3 import skew
from .model import RobotModel


class LinkState(NamedTuple):
    R: torch.Tensor       # [L,3,3] world rotations
    p: torch.Tensor       # [L,3] world origins
    axis_w: torch.Tensor  # [L,3] world joint axes (child-moving joint; 0 if fixed)


class FrameSet(NamedTuple):
    """Named auxiliary frames as device tensors (built once per name tuple)."""

    link: torch.Tensor    # [F] long: carrying link
    R: torch.Tensor       # [F,3,3] frame rotation in the link frame
    p: torch.Tensor       # [F,3] frame origin in the link frame


def _mv(A, v):
    """Batched mat-vec [..., m, n] @ [..., n] -> [..., m]."""
    return (A @ v[..., None])[..., 0]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


class KinDyn:
    """Static topology data as device tensors, built once; every method is a
    function of batched state tensors on the same device."""

    def __init__(self, model: RobotModel, dtype=torch.float32, device=None):
        self.model = model
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n = model.n_joints
        self.L = model.n_links
        self.dof_mask = model.dof_mask()                     # [L, n] bool
        # link index whose frame carries each DOF's joint (child link)
        self.link_of_joint = np.full(self.n, -1, int)
        for i, j in enumerate(model.joint_of_link):
            if j >= 0:
                self.link_of_joint[j] = i
        parent_of_joint = np.asarray(
            [model.parent_link[l] for l in self.link_of_joint])

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        def idx(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=self.device)

        self._origin_R = f(model.origin_R)
        self._origin_p = f(model.origin_p)
        self._axis = f(model.joint_axis)
        self._mass = f(model.mass)
        self._com = f(model.com)
        self._inertia = f(model.inertia)
        self._mask = f(self.dof_mask)
        self._mass_weights = self._mass / self._mass.sum()
        self._total_mass = self._mass.sum()
        self._link_of_joint = idx(self.link_of_joint)
        self._parent_of_joint = idx(parent_of_joint)
        # DOF read by each link's joint angle (0 for a fixed link, whose zero
        # axis makes the joint rotation the identity whatever angle it reads)
        self._joint_of_link = idx(np.maximum(model.joint_of_link, 0))
        self._axis_K = skew(self._axis)                      # [L,3,3]
        self._axis_K2 = self._axis_K @ self._axis_K
        self._eye3 = torch.eye(3, dtype=dtype, device=self.device)
        self._eye4_row = f([[0.0, 0.0, 0.0, 1.0]])           # [1,4]
        self._frame_sets: dict = {}

    def frames(self, names: Tuple[str, ...]) -> FrameSet:
        """The named frames as device tensors (cached per name tuple)."""
        key = tuple(names)
        fs = self._frame_sets.get(key)
        if fs is None:
            frs = [self.model.frames[n] for n in key]
            fs = FrameSet(
                link=torch.as_tensor([fr.link for fr in frs],
                                     dtype=torch.long, device=self.device),
                R=torch.as_tensor(np.stack([fr.R for fr in frs]),
                                  dtype=self.dtype, device=self.device),
                p=torch.as_tensor(np.stack([fr.p for fr in frs]),
                                  dtype=self.dtype, device=self.device))
            self._frame_sets[key] = fs
        return fs

    def frame_poses(self, ls: LinkState, fs: FrameSet, p_offset=None):
        """World (R [F,3,3], p [F,3]) of each frame of ``fs``; ``p_offset``
        [F,3] shifts the frame origins in their link frames."""
        R_l = ls.R[:, fs.link]
        p_loc = fs.p if p_offset is None else fs.p + p_offset
        return R_l @ fs.R, ls.p[:, fs.link] + _mv(R_l, p_loc)

    # ------------------------------------------------------------------
    # forward kinematics
    # ------------------------------------------------------------------

    def fk(self, base_R, base_p, q) -> LinkState:
        """World pose of every link (the tree walked parents first, one
        homogeneous 4×4 product per link)."""
        m = self.model
        B = q.shape[0]
        ang = q[:, self._joint_of_link]                      # [B,L]
        s = torch.sin(ang)[:, :, None, None]
        c = torch.cos(ang)[:, :, None, None]
        R_q = self._eye3 + s * self._axis_K + (1.0 - c) * self._axis_K2
        R_loc = self._origin_R @ R_q                         # [B,L,3,3]
        top = torch.cat(
            [R_loc, self._origin_p[None, :, :, None].expand(B, -1, -1, -1)],
            dim=-1)
        X_loc = torch.cat(
            [top, self._eye4_row.expand(B, self.L, 1, 4)], dim=-2)
        X0 = torch.cat(
            [torch.cat([base_R, base_p[:, :, None]], dim=-1),
             self._eye4_row.expand(B, 1, 4)], dim=-2)        # [B,4,4]
        Xs = [X0]
        for i in range(1, self.L):
            Xs.append(Xs[m.parent_link[i]] @ X_loc[:, i])
        X = torch.stack(Xs, dim=1)
        R = X[:, :, :3, :3]
        # R_q leaves its own axis fixed, so the world axis is R_i a_i
        return LinkState(R=R, p=X[:, :, :3, 3], axis_w=_mv(R, self._axis))

    # ------------------------------------------------------------------
    # spatial jacobians at the world origin
    # ------------------------------------------------------------------

    def joint_subspace(self, ls: LinkState):
        """[n, 6] motion subspace of each DOF at the world origin:
        s_j = [p_j × a_j ; a_j]."""
        a = ls.axis_w[:, self._link_of_joint]
        p = ls.p[:, self._link_of_joint]
        return torch.cat([_cross(p, a), a], dim=-1)

    def base_block(self, base_p):
        """[6,6] base columns at the world origin: [[I, S(p_b)],[0, I]]."""
        B = base_p.shape[0]
        eye = self._eye3.expand(B, 3, 3)
        top = torch.cat([eye, skew(base_p)], dim=-1)
        bot = torch.cat([torch.zeros_like(eye), eye], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def link_spatial_jacobians(self, ls: LinkState, base_p):
        """[L, 6, 6+n] spatial Jacobian of every link at the world origin."""
        s = self.joint_subspace(ls)                          # [B,n,6]
        # mask[i,j]=1 if joint j moves link i
        Jq = self._mask[None, :, None, :] * s.mT[:, None, :, :]
        Jb = self.base_block(base_p)[:, None].expand(-1, self.L, -1, -1)
        return torch.cat([Jb, Jq], dim=-1)

    def link_spatial_inertias(self, ls: LinkState, mass=None, inertia=None):
        """[L, 6, 6] spatial inertia of every link at the world origin, the
        links' world CoMs [L,3] and world rotational inertias [L,3,3].

        ``mass``/``inertia`` ([L] / [L,3,3], or per lane [B,L] / [B,L,3,3])
        override the model's nominal inertial parameters — the plant-side
        hook of the model-mismatch sweeps."""
        mass_ = self._mass if mass is None else mass
        inertia_ = self._inertia if inertia is None else inertia
        c_w = ls.p + _mv(ls.R, self._com)
        I_w = ls.R @ inertia_ @ ls.R.mT
        Sc = skew(c_w)
        m = mass_[..., None, None]
        mSc = m * Sc
        top = torch.cat([(m * self._eye3).expand_as(mSc), -mSc], dim=-1)
        bot = torch.cat([mSc, I_w - mSc @ Sc], dim=-1)
        return torch.cat([top, bot], dim=-2), c_w, I_w

    # ------------------------------------------------------------------
    # aggregate quantities
    # ------------------------------------------------------------------

    def mass_matrix(self, J, I_sp):
        """Free-floating mass matrix [6+n, 6+n] (mixed representation)
        = Σ_k J_kᵀ I_k J_k."""
        return J.flatten(1, 2).mT @ (I_sp @ J).flatten(1, 2)

    def com(self, c_w):
        return torch.einsum("l,bla->ba", self._mass_weights, c_w)

    def momentum_matrix_origin(self, J, I_sp):
        """[6, 6+n] momentum map at the world origin: h_O = A_O ν."""
        return (I_sp @ J).sum(dim=1)

    def centroidal_momentum_matrix(self, A_O, com):
        """Transport the momentum map to the CoM (world orientation)."""
        return torch.cat(
            [A_O[:, 0:3], A_O[:, 3:6] - skew(com) @ A_O[:, 0:3]], dim=-2)

    def com_jacobian(self, J, c_w):
        """[3, 6+n] CoM velocity map."""
        # v_comk = [I, -S(c_k)] V_k
        lin = J[:, :, 0:3, :] - skew(c_w) @ J[:, :, 3:6, :]
        return (self._mass_weights[:, None, None] * lin).sum(dim=1)

    def frame_jacobian(self, J, ls: LinkState, link, p_frame):
        """[6, 6+n] mixed Jacobian of a frame on ``link`` at world position
        ``p_frame`` [3]; with ``link`` an index tensor [F] and ``p_frame``
        [F,3], the [F, 6, 6+n] Jacobians of F frames at once."""
        Jl = J[:, link]
        lin = Jl[..., 0:3, :] - skew(p_frame) @ Jl[..., 3:6, :]
        return torch.cat([lin, Jl[..., 3:6, :]], dim=-2)

    def bias_forces(self, J, I_sp, ls: LinkState, base_p, nu, gravity):
        """Generalised bias τ_bias = C(q,ν)ν + G(q): [6+n].

        Common-frame RNEA: Ā_k = J̇_k ν − [g;0];
        τ = Σ J_kᵀ(I_k Ā_k + V_k ×* I_k V_k)."""
        V = _mv(J, nu[:, None, :])                           # [B,L,6]
        # J̇ν per link: joint columns + base column derivative
        a = ls.axis_w[:, self._link_of_joint]
        p = ls.p[:, self._link_of_joint]
        Vp = V[:, self._parent_of_joint]                     # parent link vel [n,6]
        w_par = Vp[..., 3:6]
        v_par_O = Vp[..., 0:3]
        a_dot = _cross(w_par, a)
        p_dot = v_par_O + _cross(w_par, p)
        s_dot = torch.cat(
            [_cross(p_dot, a) + _cross(p, a_dot), a_dot], dim=-1)  # [B,n,6]
        qd = nu[:, 6:]
        Jdot_nu_q = self._mask @ (s_dot * qd[:, :, None])    # [B,L,6]
        # base column derivative [v_b × ω_b; 0], and the gravity trick: a
        # fictitious upward base acceleration
        vb, wb = nu[:, 0:3], nu[:, 3:6]
        base_bias = torch.cat([_cross(vb, wb) - gravity,
                               torch.zeros_like(vb)], dim=-1)
        Abias = Jdot_nu_q + base_bias[:, None, :]
        # spatial force per link: I Ā + V ×* I V
        IV = _mv(I_sp, V)
        f_cross = torch.cat([
            _cross(V[..., 3:6], IV[..., 0:3]),
            _cross(V[..., 3:6], IV[..., 3:6])
            + _cross(V[..., 0:3], IV[..., 0:3]),
        ], dim=-1)
        F = _mv(I_sp, Abias) + f_cross
        return _mv(J.flatten(1, 2).mT, F.flatten(1, 2))

    def relative_jacobian(self, J, ls: LinkState, link, p_frame):
        """[6, n] joint columns of the frame's mixed Jacobian with the base
        held fixed — the base-relative Jacobian the λ couplings consume."""
        return self.frame_jacobian(J, ls, link, p_frame)[..., 6:]


# ---------------------------------------------------------------------------
# snapshot producer
# ---------------------------------------------------------------------------


def compute_snapshot(kd: KinDyn, jets: Tuple[str, ...], base_R, base_p,
                     base_vel, q, qd, jet_thrusts,
                     jet_axis_local=(0.0, 0.0, -1.0),
                     ext_wrench_frames: Tuple[str, ...] = (),
                     ext_wrenches_body=None,
                     ground_threshold: float = 5.0) -> RobotSnapshot:
    """Everything the MPC needs from one measured state per lane.

    ``base_vel`` = [v_base_origin(world); ω(world)] (mixed). Jet thrust acts
    along the jet frame's local ``jet_axis_local``.

    When ``ext_wrench_frames``/``ext_wrenches_body`` ([W, 6] force+torque in
    each named frame) are given, the snapshot also carries the aggregated
    external wrench, the ZMP and the ground-contact flag.
    """
    B = q.shape[0]
    nu = torch.cat([base_vel, qd], dim=-1)
    ls = kd.fk(base_R, base_p, q)
    J = kd.link_spatial_jacobians(ls, base_p)
    I_sp, c_w, I_w_links = kd.link_spatial_inertias(ls)
    com = kd.com(c_w)
    A_O = kd.momentum_matrix_origin(J, I_sp)
    A_G = kd.centroidal_momentum_matrix(A_O, com)
    h_G = _mv(A_G, nu)                               # world momentum at CoM
    Rt = base_R.mT
    h_body = torch.cat([_mv(Rt, h_G[:, :3]), _mv(Rt, h_G[:, 3:])], dim=-1)
    # locked inertia at CoM, body orientation: Rᵀ I_G R
    Sc = skew(c_w - com[:, None, :])
    I_G = (I_w_links - kd._mass[:, None, None] * Sc @ Sc).sum(dim=1)
    inertia_locked = Rt @ I_G @ base_R

    jcom = kd.com_jacobian(J, c_w)

    fs = kd.frames(jets)
    R_f, p_f = kd.frame_poses(ls, fs)
    axis_local = const_tensor(tuple(float(a) for a in jet_axis_local),
                              kd.dtype, kd.device)
    axes = _mv(R_f, axis_local)                      # [B,4,3]
    arms = p_f - com[:, None, :]
    Jf = kd.frame_jacobian(J, ls, fs.link, p_f)      # [B,4,6,6+n]
    rel = Jf[..., 6:]

    # A_mom (world): force rows = axes; torque rows = arm × axis
    amom_body = torch.cat(
        [Rt @ axes.mT, Rt @ _cross(arms, axes).mT], dim=-2)  # [B,6,4]

    ext_sum = zmp_pt = on_ground = None
    if ext_wrench_frames:
        from .wrenches import compute_wrench_summary
        ws = compute_wrench_summary(
            kd, ls, J, com, ext_wrench_frames, ext_wrenches_body, jcom,
            ground_threshold)
        ext_sum, zmp_pt, on_ground = ws.sum_world, ws.zmp, ws.on_ground

    return RobotSnapshot(
        ext_wrench_sum=ext_sum, zmp=zmp_pt, on_ground=on_ground,
        w_R_b=base_R,
        base_pos=base_p,
        base_ang_vel_world=base_vel[:, 3:6],
        com_pos=com,
        total_mass=kd._total_mass.expand(B),
        momentum_body=h_body,
        inertia_locked=inertia_locked,
        amom_jets_body=amom_body,
        jet_axes_world=axes,
        jet_arms_world=arms,
        jac_jets_lin_joints=rel[..., 0:3, :],
        jac_com_joints=jcom[:, :, 6:],
        rel_jac_lin=rel[..., 0:3, :],
        rel_jac_ang=rel[..., 3:6, :],
        joint_pos=q,
        jet_thrusts=jet_thrusts,
    )
