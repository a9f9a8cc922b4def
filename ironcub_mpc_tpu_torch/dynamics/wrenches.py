"""External-wrench aggregation, ZMP and ground-contact detection
(counterpart of ``ironcub_mpc_tpu/dynamics/wrenches.py``).

Wrenches measured in body-fixed frames are transported to the world frame
and summed, the zero-moment point is computed from the total wrench, the
ground-contact flag compares the vertical force against the configured
threshold, and per-wrench momentum-map (``A_mom``) and coupling (``Λ``)
matrices are exposed for controllers that feed contact wrenches into the
centroidal dynamics. Every tensor carries a leading batch dimension B;
shapes below are per lane.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops.so3 import skew
from .kinodynamics import KinDyn, LinkState, _cross, _mv


class WrenchSummary(NamedTuple):
    sum_world: torch.Tensor        # [6] total wrench at the world origin-ish
    wrenches_mixed: torch.Tensor   # [W,6] each wrench rotated to world axes
    zmp: torch.Tensor              # [3] zero-moment point (xy; z = 0)
    on_ground: torch.Tensor        # [] bool
    amom: torch.Tensor             # [W,6,6] wrench -> centroidal momentum rate
    lambda_mom: torch.Tensor       # [6, 6+n] Σ coupling of wrench app. points


def compute_wrench_summary(kd: KinDyn, ls: LinkState, J, com,
                           frame_names: Sequence[str], wrenches_body,
                           jac_com, threshold: float) -> WrenchSummary:
    """``wrenches_body``: [W, 6] (force, torque) in each named frame.

    - sum: each wrench moved to world via the frame's wrench adjoint;
    - mixed: rotation only, no moment transport;
    - ZMP from the summed wrench: x = −τy/fz, y = τx/fz, zero off the ground;
    - A_mom per wrench: wrench adjoint of the (I, p − com) transform;
    - Λ: −S(f_world) · (J_lin − J_com) rows.

    ``on_ground`` stays a tensor: nothing here is read on the host.
    """
    B = com.shape[0]
    dt_, dev = ls.p.dtype, ls.p.device
    W = len(frame_names)
    if W == 0:
        z = lambda *s: torch.zeros((B, *s), dtype=dt_, device=dev)  # noqa: E731
        sums = z(6)
        mixed, amoms, lam = z(0, 6), z(0, 6, 6), z(6, 6 + kd.n)
    else:
        fs = kd.frames(tuple(frame_names))
        R_f, p_f = kd.frame_poses(ls, fs)
        f_w = _mv(R_f, wrenches_body[..., :3])               # [B,W,3]
        tau_w = _mv(R_f, wrenches_body[..., 3:])
        sums = torch.cat([f_w, tau_w + _cross(p_f, f_w)], dim=-1).sum(dim=1)
        mixed = torch.cat([f_w, tau_w], dim=-1)
        eye = torch.eye(3, dtype=dt_, device=dev).expand(B, W, 3, 3)
        amoms = torch.cat(
            [torch.cat([eye, torch.zeros_like(eye)], dim=-1),
             torch.cat([skew(p_f - com[:, None, :]), eye], dim=-1)], dim=-2)
        Jf = kd.frame_jacobian(J, ls, fs.link, p_f)          # [B,W,6,6+n]
        lam_ang = (-skew(f_w) @ (Jf[..., 0:3, :] - jac_com[:, None])
                   ).sum(dim=1)
        lam = torch.cat([torch.zeros_like(lam_ang), lam_ang], dim=-2)
    fz = sums[:, 2]
    on_ground = fz > threshold
    fz_safe = torch.where(fz == 0, torch.ones_like(fz), fz)
    zmp = torch.stack([-sums[:, 4] / fz_safe, sums[:, 3] / fz_safe,
                       torch.zeros_like(fz)], dim=-1)
    zmp = torch.where(on_ground[:, None], zmp, torch.zeros_like(zmp))
    return WrenchSummary(sum_world=sums, wrenches_mixed=mixed, zmp=zmp,
                         on_ground=on_ground, amom=amoms, lambda_mom=lam)
