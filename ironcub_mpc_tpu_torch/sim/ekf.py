"""Batched extended Kalman filter over per-jet (T, Ṫ) states (counterpart of
``ironcub_mpc_tpu/sim/ekf.py``).

One EKF written once over tensors [..., 4, 2]: the leading dimensions (lanes)
and the jet dimension broadcast, where the JAX package nests ``vmap``. The
Jacobian of the discrete jet model comes in closed form from
:func:`ironcub_mpc_tpu_torch.ops.jet_model.step_jacobians`.

Measurement model: z = [T, Ṫ] from the LSTM plant model, H = I.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops import jet_model as jm


class EKFState(NamedTuple):
    x: torch.Tensor   # [..., 4, 2] per-jet (T, Ṫ)
    P: torch.Tensor   # [..., 4, 2, 2] covariances


class JetEKF:
    """Per-jet EKF with diagonal R/Q/P0 scales."""

    def __init__(self, dt: float, r=0.5, q=0.1, p0=0.1, dtype=torch.float32,
                 device=None):
        dev = resolve_device(device)
        eye = torch.eye(2, dtype=dtype, device=dev)
        self.dt = dt
        self.R = eye * r
        self.Q = eye * q
        self.P0 = eye * p0
        self.dtype = dtype
        self.device = dev

    def init(self, thrust0) -> EKFState:
        t0 = torch.as_tensor(thrust0, dtype=self.dtype, device=self.device)
        x = torch.stack([t0, torch.zeros_like(t0)], dim=-1)
        P = self.P0.expand(x.shape[:-1] + (2, 2)).contiguous()
        return EKFState(x=x, P=P)

    def update(self, state: EKFState, throttle, z_thrust, z_thrust_dot):
        """Predict + correct, all jets and lanes at once: throttle [..., 4],
        measurements [..., 4]."""
        x, P = state.x, state.P
        z = torch.stack([z_thrust, z_thrust_dot], dim=-1)
        x_pred = torch.stack(jm.step(x[..., 0], x[..., 1], throttle, self.dt),
                             dim=-1)
        # reference quirk, kept: the Jacobian is evaluated at the *predicted*
        # state (A(x, u) is called after x = f(x, u))
        A, _ = jm.step_jacobians(x_pred, throttle, self.dt)
        P_pred = A @ P @ A.mT + self.Q
        err = z - x_pred
        S = P_pred + self.R
        # closed-form 2x2 inverse
        det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
        S_inv = torch.stack([
            torch.stack([S[..., 1, 1], -S[..., 0, 1]], dim=-1),
            torch.stack([-S[..., 1, 0], S[..., 0, 0]], dim=-1)],
            dim=-2) / det[..., None, None]
        K = P_pred @ S_inv
        x_new = x_pred + (K @ err[..., None])[..., 0]
        P_new = (torch.eye(2, dtype=P.dtype, device=P.device) - K) @ P_pred
        return EKFState(x=x_new, P=P_new)
