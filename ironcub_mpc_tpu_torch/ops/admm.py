"""Solver settings and status codes of the condensed box-QP solve
(the part of ``ironcub_mpc_tpu/ops/admm.py`` that the condensed path uses).

The OSQP scheme itself lives in :mod:`ironcub_mpc_tpu_torch.qp.condensed`;
the full-space solver is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# status codes
UNSOLVED = 0
SOLVED = 1
SOLVED_INACCURATE = 2
PRIMAL_INFEASIBLE = 3
DUAL_INFEASIBLE = 4
MAX_ITER_REACHED = 5

KERNEL_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class ADMMSettings:
    """Solver settings; defaults follow OSQP's (v0.6), field for field those
    of the JAX package's ``ADMMSettings``, except two:

    - ``kernel_mode`` replaces ``pallas_mode``: "auto" and "on" take the
      full padded layout of the hand-written kernels (``ops/kernels.py``),
      which launch their CUDA kernel for CUDA tensors and run their plain
      PyTorch twin for CPU tensors; "off" is the unpadded box-layout path.
    - ``batch_guard`` replaces ``guard_axis``: True makes every per-lane
      solver branch one batch-wide decision (``any`` over the lanes, the
      ``psum`` over the vmap axis of the JAX package), taken on the host;
      False keeps each decision per lane (both branches computed and joined
      with ``torch.where``, which is what ``lax.cond`` under ``vmap`` does).
    """

    rho: float = 0.1
    rho_eq_scale: float = 1e3       # equality rows use rho * rho_eq_scale
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 250
    # staged adaptive rho: at these iteration counts the scaled residual
    # ratio re-tunes rho and K⁻¹ is refreshed.
    rho_update_iters: tuple = (25, 75, 150)
    adaptive_rho_tolerance: float = 5.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_pinf: float = 1e-4
    eps_dinf: float = 1e-4
    scaling_iters: int = 10
    polish: bool = True
    delta_polish: float = 1e-6
    polish_refine_iters: int = 3
    eq_tol: float = 1e-9            # l==u detection tolerance
    inf_bound: float = 1e20         # OSQP_INFTY analogue (finite in fp32)
    # carry (K(ρ))⁻¹ across ticks, refreshed by Woodbury + Newton–Schulz
    kinv_carry: bool = True
    # Newton–Schulz depth after each Woodbury refresh of the carried
    # inverse (minimum 1: the raw fp32 Woodbury error stalls the dual
    # residual), and on the Schur-polish operator (0 allowed: the refine
    # iterations run against the exact operator).
    ns_steps: int = 1
    polish_ns_steps: int = 0
    # skip the carried-inverse refresh when its probe residual against the
    # current K(H, ρ) is already <= this tolerance (0 = refresh every tick)
    ns_skip_tol: float = 0.0
    # verify the refreshed inverse and re-factorise a lane that left the
    # Newton–Schulz contraction basin
    kinv_guard: bool = True
    # batch-wide solver decisions (see the class docstring)
    batch_guard: bool = False
    # ignore the carried (K⁻¹, ρ) for this solve (fresh factorisation),
    # still writing the fresh state back into the carry
    kinv_reset: bool = False
    # > 0: run each ADMM segment in chunks of this many iterations and skip
    # the remaining chunks once every lane (batch_guard) or the lane meets
    # the termination criterion
    term_check_every: int = 0
    kernel_mode: str = "auto"

    def __post_init__(self):
        if self.ns_steps < 1:
            raise ValueError(f"ns_steps must be >= 1, got {self.ns_steps}")
        if self.polish_ns_steps < 0:
            raise ValueError(
                f"polish_ns_steps must be >= 0, got {self.polish_ns_steps}")
        if not 0.0 <= self.ns_skip_tol < 0.1:
            raise ValueError(
                "ns_skip_tol must be in [0, 0.1) — 0.1 is the kinv_guard "
                f"recovery threshold; got {self.ns_skip_tol}")
        if self.term_check_every < 0:
            raise ValueError("term_check_every must be >= 0, got "
                             f"{self.term_check_every}")
        if self.kernel_mode not in KERNEL_MODES:
            raise ValueError(f"kernel_mode must be one of {KERNEL_MODES}, "
                             f"got {self.kernel_mode!r}")


def kernels_enabled(settings: ADMMSettings) -> bool:
    """True when the solve takes the padded layout of ``ops/kernels.py``."""
    return settings.kernel_mode != "off"


class Scaling(NamedTuple):
    """Full-space Ruiz equilibration (x̄ = D⁻¹x, cost scaled by c). The
    condensed path keeps the identity scaling in ``MPCProblem.scaling``."""

    d: torch.Tensor  # [n] primal scaling
    e: torch.Tensor  # [m] dual scaling
    c: torch.Tensor  # [] cost scaling


def _safe_inv_sqrt(v, lo=1e-8, hi=1e8):
    """1/sqrt with OSQP's zero-row rule: an (almost) zero norm keeps its
    scale at exactly 1."""
    inv = 1.0 / torch.sqrt(torch.clamp(v, lo, hi))
    return torch.where(v < lo, torch.ones_like(inv), inv)
