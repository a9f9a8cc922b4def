"""SO(3) / RPY algebra (counterpart of ``ironcub_mpc_tpu/ops/so3.py``).

Rotations are world-from-body, RPY is the intrinsic roll-pitch-yaw
parameterisation with ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``, and the
Euler-rate map ``W`` gives ``ω_body = W(φ) φ̇``. Every function broadcasts
over leading dimensions.
"""

from __future__ import annotations

import math

import torch


def _mat3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def skew(x):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    z = torch.zeros_like(x0)
    return _mat3([[z, -x2, x1], [x2, z, -x0], [-x1, x0, z]])


def unskew(m):
    """Skew-symmetric [..., 3, 3] -> [..., 3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def inv3(M):
    """Closed-form 3x3 inverse (adjugate / determinant), no pivoting; for
    well-conditioned physical matrices (inertia tensors, Euler-rate maps)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    return _mat3([[A, B, Cc], [D, E, F], [G, H, I]]) / det[..., None, None]


def rotx(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[o, z, z], [z, c, -s], [z, s, c]])


def roty(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rotz(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def rpy_to_matrix(rpy):
    """RPY -> rotation matrix, R = Rz(y) Ry(p) Rx(r)."""
    return rotz(rpy[..., 2]) @ roty(rpy[..., 1]) @ rotx(rpy[..., 0])


def matrix_to_rpy(R):
    """Rotation matrix -> RPY: pitch = asin(-R[2,0]), roll = atan2(R[2,1],
    R[2,2]), yaw = atan2(R[1,0], R[0,0]) (no gimbal-lock branch)."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_rate_matrix(rpy):
    """W(φ) with ω_body = W φ̇."""
    r, p = rpy[..., 0], rpy[..., 1]
    o, z = torch.ones_like(r), torch.zeros_like(r)
    cr, sr, cp, sp = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p)
    return _mat3([[o, z, -sp], [z, cr, cp * sr], [z, -sr, cr * cp]])


def euler_rate_matrix_inv(rpy):
    """W(φ)⁻¹ in closed form."""
    r, p = rpy[..., 0], rpy[..., 1]
    o, z = torch.ones_like(r), torch.zeros_like(r)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, tp = torch.cos(p), torch.tan(p)
    return _mat3([[o, sr * tp, cr * tp], [z, cr, -sr],
                  [z, sr / cp, cr / cp]])


def unwrap_rpy(rpy_new, rpy_old, n_turns):
    """Incremental RPY unwrapping with ±2π turn counting: turns decrement
    when the raw angle jumps up by more than π, increment when it jumps
    down. ``n_turns`` stays int32. Returns (unwrapped, new_turn_counts)."""
    diff = rpy_new - rpy_old
    n_turns = n_turns - (diff > math.pi).to(n_turns.dtype)
    n_turns = n_turns + (diff < -math.pi).to(n_turns.dtype)
    return rpy_new + 2.0 * math.pi * n_turns, n_turns
