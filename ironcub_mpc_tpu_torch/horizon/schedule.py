"""Variable-sampling-time horizon: time warp, dt schedule, input blocking.

This is the paper's core idea — a single QP whose first ``nIterSmall`` knots
use a quadratically *warped* timestep growing from the controller period
(5 ms) so that they exactly tile one large step (100 ms), followed by
large-step knots. Joint inputs get one knot per step up to the control
horizon (then hold); throttle inputs are *blocked*: all small steps share
knot 0, then one knot per large step (then hold) — so the throttle command
effectively updates at the large-step rate while joints update every tick.

Reference: warp + discretisation loop ``constraintsVSMPC.cpp:45-52,76-131``.

TPU-first design note: everything here is computed **once at trace time**
with plain Python/NumPy and becomes compile-time constants — the XLA graph
never sees the branchy index logic, only dense gathers built from these maps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.config import MPCConfig


@dataclasses.dataclass(frozen=True)
class HorizonSchedule:
    """Static description of the multi-rate horizon (trace-time constants)."""

    n_iter: int
    n_iter_small: int
    control_horizon: int
    beta1: float
    beta2: float
    # per-knot integration step, shape [n_iter]
    dts: tuple
    # joint input knot used by dynamics step i, shape [n_iter]
    joint_knot_of_step: tuple
    # throttle input knot used by dynamics step i, shape [n_iter]
    throttle_knot_of_step: tuple

    @property
    def total_span(self) -> float:
        return float(np.sum(self.dts))

    def dts_array(self) -> np.ndarray:
        return np.asarray(self.dts, dtype=np.float64)


def warp(tau: float, beta1: float, beta2: float) -> float:
    """Quadratic time warp w(τ) = β₁τ + β₂τ² (constraintsVSMPC.cpp:156-159)."""
    return beta1 * tau + beta2 * tau * tau


def warp_betas(cfg: MPCConfig) -> tuple[float, float]:
    """Solve for β₁, β₂ s.t. w(1)-w(0)=Δt_s and w(n_s)=Δt_L.

    Reference closed form (constraintsVSMPC.cpp:49-51):
    β₂ = (Δt_L − n_s·Δt_s) / (n_s(n_s−1)),  β₁ = Δt_s − β₂.
    """
    n_s = cfg.n_iter_small
    beta2 = (cfg.period_mpc_large_steps - n_s * cfg.period_mpc_small_steps) / (
        n_s * (n_s - 1))
    beta1 = cfg.period_mpc_small_steps - beta2
    return beta1, beta2


def build_schedule(cfg: MPCConfig) -> HorizonSchedule:
    """Build the full static horizon schedule from an :class:`MPCConfig`."""
    beta1, beta2 = warp_betas(cfg)
    n, n_s, ch = cfg.n_iter, cfg.n_iter_small, cfg.control_horizon

    dts = []
    for i in range(n):
        if i < n_s:
            dts.append(warp(i + 1, beta1, beta2) - warp(i, beta1, beta2))
        else:
            dts.append(cfg.period_mpc_large_steps)

    # joint input blocking (constraintsVSMPC.cpp:89-103): one knot per step up
    # to the control horizon, last knot held beyond it.
    joint_knot = [min(i, ch - 1) for i in range(n)]

    # throttle blocking (constraintsVSMPC.cpp:104-128): all small steps share
    # knot 0; then one knot per step up to the control horizon; held after.
    throttle_knot = []
    for i in range(n):
        if i < n_s:
            throttle_knot.append(0)
        elif i < ch:
            throttle_knot.append(i - (n_s - 1))
        else:
            throttle_knot.append(ch - n_s)

    return HorizonSchedule(
        n_iter=n,
        n_iter_small=n_s,
        control_horizon=ch,
        beta1=beta1,
        beta2=beta2,
        dts=tuple(dts),
        joint_knot_of_step=tuple(joint_knot),
        throttle_knot_of_step=tuple(throttle_knot),
    )
