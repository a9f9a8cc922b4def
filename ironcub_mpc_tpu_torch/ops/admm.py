"""Batched dense ADMM solver for convex QPs — the OSQP algorithm
(counterpart of ``ironcub_mpc_tpu/ops/admm.py``).

Solves  min ½xᵀPx + qᵀx  s.t.  l ≤ Ax ≤ u  for every lane of a leading
batch dimension B with the operator-splitting iteration of OSQP (Stellato
et al. 2020): Ruiz equilibration, σ-regularised reduced KKT system,
over-relaxed ADMM with per-constraint ρ (equality rows get ρ·10³), staged
adaptive ρ, warm starting, active-set polishing and primal/dual
infeasibility certificates. This is the full-space solver of
``MPCConfig(qp_solver="full")``; the settings and status codes are shared
with the condensed box-QP solve of :mod:`ironcub_mpc_tpu_torch.qp.condensed`.

Vectors are [B, n] or [B, m]; a matrix is [B, ·, ·] or, shared by every
lane, [·, ·]; a :class:`Scaling` is per lane or shared. Every reduction runs
over a lane's own axes. The linear algebra is stock fp32 ``torch.linalg``
(the JAX package runs no Pallas kernel on this path): a Cholesky of K once
a ρ stage, two triangular solves an iteration, a partially pivoted LU of
the polish KKT matrix. The factorisations never make the host wait: a lane
whose matrix does not factor gets a NaN factor, as XLA gives.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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
    """Ruiz equilibration result: x̄ = D⁻¹x, scaled cost ½x̄ᵀP̄x̄ + c q̄ᵀx̄.
    The condensed path keeps the identity scaling in
    ``MPCProblem.scaling``."""

    d: torch.Tensor  # [n] (or [B, n]) primal scaling
    e: torch.Tensor  # [m] (or [B, m]) dual scaling
    c: torch.Tensor  # [] (or [B]) cost scaling


def _safe_inv_sqrt(v, lo=1e-8, hi=1e8):
    """1/sqrt with OSQP's zero-row rule: an (almost) zero norm keeps its
    scale at exactly 1."""
    inv = 1.0 / torch.sqrt(torch.clamp(v, lo, hi))
    return torch.where(v < lo, torch.ones_like(inv), inv)


class QPData(NamedTuple):
    """Scaled problem data + factorisation, ready to iterate."""

    P: torch.Tensor        # [n, n] or [B, n, n] scaled
    q: torch.Tensor        # [B, n] scaled
    A: torch.Tensor        # [B, m, n] scaled
    l: torch.Tensor        # [B, m] scaled
    u: torch.Tensor        # [B, m] scaled
    rho_vec: torch.Tensor  # [B, m] per-constraint rho
    chol_K: torch.Tensor   # [B, n, n] lower Cholesky of P + σI + AᵀρA
    scaling: Scaling


class QPSolution(NamedTuple):
    x: torch.Tensor           # [B, n] primal solution (unscaled)
    y: torch.Tensor           # [B, m] dual solution (unscaled)
    z: torch.Tensor           # [B, m] constraint activation Ax (unscaled)
    status: torch.Tensor      # [B] int32 status code
    iterations: torch.Tensor  # [B] int32
    pri_res: torch.Tensor     # [B] final unscaled primal residual (inf-norm)
    dua_res: torch.Tensor     # [B] final unscaled dual residual (inf-norm)


def _mv(M, v):
    """[..., m, n] @ [B, n] -> [B, m]."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """[..., m, n]ᵀ @ [B, m] -> [B, n]."""
    return (M.mT @ v[..., None])[..., 0]


def _clip(v, lo, hi):
    """jnp.clip: NaN stays NaN."""
    return torch.minimum(torch.maximum(v, lo), hi)


def _nan_where_failed(M, info, nan):
    """A lane whose factorisation reported ``info != 0`` gets ``nan``."""
    return torch.where((info != 0)[..., None, None], nan, M)


def _inf_norm_cols(M):
    return M.abs().amax(dim=-2)


def _inf_norm_rows(M):
    return M.abs().amax(dim=-1)


def ruiz_equilibration(P, q, A, l, u, iters: int = 10):
    """Modified Ruiz equilibration of [[P, Aᵀ], [A, 0]] + cost scaling, per
    lane. Returns scaled (P̄, q̄, Ā, l̄, ū) and the :class:`Scaling` ([B, n],
    [B, m], [B]): per-iteration inf-norm column equilibration of the stacked
    KKT matrix, then cost normalisation by max(mean col-norm of P̄, ‖q̄‖∞)."""
    n, m = P.shape[-1], A.shape[-2]
    batch = q.shape[:-1]
    like = dict(dtype=q.dtype, device=q.device)
    D = torch.ones(batch + (n,), **like)
    E = torch.ones(batch + (m,), **like)
    c = torch.ones(batch, **like)
    for _ in range(iters):
        d = _safe_inv_sqrt(torch.maximum(_inf_norm_cols(P), _inf_norm_cols(A)))
        e = _safe_inv_sqrt(_inf_norm_rows(A))
        P = d[..., :, None] * P * d[..., None, :]
        q = d * q
        A = e[..., :, None] * A * d[..., None, :]
        l = e * l
        u = e * u
        D = D * d
        E = E * e
        # cost scaling
        norm_q = q.abs().amax(dim=-1)
        mean_col_P = _inf_norm_cols(P).mean(dim=-1)
        g = 1.0 / torch.clamp(torch.maximum(mean_col_P, norm_q), 1e-8, 1e8)
        P = g[..., None, None] * P
        q = g[..., None] * q
        c = c * g
    return P, q, A, l, u, Scaling(D, E, c)


def rho_vector(l, u, settings: ADMMSettings, rho_scalar=None):
    """Per-constraint rho [B, m]: equality rows (l==u) get
    rho · rho_eq_scale, loose rows (l=-inf, u=+inf) rho · 1e-6.
    ``rho_scalar`` is None (the settings' ρ) or one ρ per lane [B]."""
    rho0 = settings.rho if rho_scalar is None else rho_scalar[..., None]
    eq = (u - l) < settings.eq_tol
    loose = (l < -settings.inf_bound * 0.9) & (u > settings.inf_bound * 0.9)
    rho = torch.ones_like(l) * rho0
    rho = torch.where(loose, rho * 1e-6, rho)
    return torch.where(eq, rho * settings.rho_eq_scale, rho)


def cholesky(K):
    """Lower Cholesky factor of K, symmetrised first as
    ``jnp.linalg.cholesky`` does; a lane where K is not positive definite
    gets NaN in the lower triangle, as XLA gives."""
    L, info = torch.linalg.cholesky_ex((K + K.mT) / 2)
    return _nan_where_failed(L, info, torch.full_like(L, float("nan")).tril())


def factorize(P, A, rho_vec, sigma):
    """Cholesky of the reduced KKT matrix K = P + σI + AᵀρA."""
    n = P.shape[-1]
    K = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    return cholesky(K + A.mT @ (rho_vec[..., :, None] * A))


def prepare(P, q, A, l, u, settings: ADMMSettings = ADMMSettings(),
            scaling: Optional[Scaling] = None) -> QPData:
    """Scale the problem and factorise the reduced KKT matrix.

    If ``scaling`` is given it is reused (OSQP computes equilibration once at
    setup and keeps it across ticks, so the constant Hessian keeps a constant
    scaling); a shared P and a shared scaling keep the scaled P shared."""
    if scaling is None:
        P, q, A, l, u, scaling = ruiz_equilibration(
            P, q, A, l, u, settings.scaling_iters)
    else:
        d, e, c = scaling
        P = c[..., None, None] * d[..., :, None] * P * d[..., None, :]
        q = c[..., None] * d * q
        A = e[..., :, None] * A * d[..., None, :]
        l = e * l
        u = e * u
    rho_vec = rho_vector(l, u, settings)
    chol_K = factorize(P, A, rho_vec, settings.sigma)
    return QPData(P, q, A, l, u, rho_vec, chol_K, scaling)


def _cho_solve(chol_K, b):
    t = torch.linalg.solve_triangular(chol_K, b[..., None], upper=False)
    return torch.linalg.solve_triangular(chol_K.mT, t, upper=True)[..., 0]


def _iterate(data: QPData, settings: ADMMSettings, x, z, y):
    """One over-relaxed ADMM iteration (OSQP alg. 1)."""
    rho, sigma, alpha = data.rho_vec, settings.sigma, settings.alpha
    rhs = sigma * x - data.q + _mtv(data.A, rho * z - y)
    x_t = _cho_solve(data.chol_K, rhs)
    z_t = _mv(data.A, x_t)
    x_new = alpha * x_t + (1.0 - alpha) * x
    z_relax = alpha * z_t + (1.0 - alpha) * z
    z_unproj = z_relax + y / rho
    z_new = _clip(z_unproj, data.l, data.u)
    y_new = rho * (z_unproj - z_new)
    return x_new, z_new, y_new


def _residuals(data: QPData, x, z, y):
    """Unscaled primal/dual residual inf-norms + scale factors for eps, per
    lane [B]."""
    d, e, c = data.scaling
    Ax = _mv(data.A, x)
    pri = _inf_norm_rows((Ax - z) / e)
    Px = _mv(data.P, x)
    Aty = _mtv(data.A, y)
    dua = _inf_norm_rows((Px + data.q + Aty) / d) / c
    pri_scale = torch.maximum(_inf_norm_rows(Ax / e), _inf_norm_rows(z / e))
    dua_scale = torch.maximum(
        torch.maximum(_inf_norm_rows(Px / d), _inf_norm_rows(Aty / d)),
        _inf_norm_rows(data.q / d)) / c
    return pri, dua, pri_scale, dua_scale


def _infeasibility_certificates(data: QPData, dx, dy, settings: ADMMSettings):
    """OSQP primal/dual infeasibility checks on the iterate deltas, per lane
    [B]."""
    d, e, c = data.scaling
    # primal infeasibility: dy is a certificate
    dy_un = dy * e / c[..., None]
    norm_dy = _inf_norm_rows(dy_un)
    eps_p = settings.eps_pinf * torch.clamp_min(norm_dy, 1e-30)
    Atdy = _inf_norm_rows(_mtv(data.A, dy) / d) / c
    u_un, l_un = data.u / e, data.l / e
    support = ((u_un * torch.clamp_min(dy_un, 0.0)).sum(dim=-1)
               + (l_un * torch.clamp_max(dy_un, 0.0)).sum(dim=-1))
    pinf = (Atdy <= eps_p) & (support <= -eps_p) & (norm_dy > 1e-30)
    # dual infeasibility: dx is a certificate
    dx_un = dx * d
    norm_dx = _inf_norm_rows(dx_un)
    eps_d = settings.eps_dinf * torch.clamp_min(norm_dx, 1e-30)
    Pdx = _inf_norm_rows(_mv(data.P, dx) / d) / c
    qdx = (data.q * dx).sum(dim=-1) / c
    Adx = _mv(data.A, dx) / e
    big = settings.inf_bound * 0.9
    eps_col = eps_d[..., None]
    upper_ok = torch.where(data.u / e < big, Adx <= eps_col, True).all(dim=-1)
    lower_ok = torch.where(data.l / e > -big, Adx >= -eps_col,
                           True).all(dim=-1)
    dinf = ((Pdx <= eps_d) & (qdx <= -eps_d) & upper_ok & lower_ok
            & (norm_dx > 1e-30))
    return pinf, dinf


def polish(data: QPData, settings: ADMMSettings, x, z, y):
    """Active-set polish (OSQP ``polish.c``), batch-safe via row masking.

    Builds the regularised KKT system on the active rows (y<0 → lower
    active, y>0 → upper active; equality rows always active) with inactive
    rows replaced by δ·ν=0 equations, factors it by partially pivoted LU,
    then runs a fixed number of iterative-refinement steps against the
    unregularised operator. A lane keeps its ADMM iterate where polishing
    does not lower the residuals.

    The KKT matrix is [B, n+m, n+m]: at the MPC's full width (n + m = 1100)
    that is 4.8 MB a lane, 310 MB at B = 64 and 5 GB at B = 1024."""
    n = data.P.shape[-1]
    m = data.A.shape[-2]
    B = data.q.shape[0]
    like = dict(dtype=data.q.dtype, device=data.q.device)
    delta = settings.delta_polish
    eq = (data.u - data.l) < settings.eq_tol
    active = (y < 0.0) | (y > 0.0) | eq
    b_act = torch.where(y < 0.0, data.l, data.u)
    b_act = torch.where(eq, data.u, b_act)
    b_act = torch.where(active, b_act, 0.0)
    A_masked = torch.where(active[..., :, None], data.A, 0.0)
    rhs = torch.cat([-data.q, b_act], dim=-1)

    top = torch.cat([(data.P + delta * torch.eye(n, **like)).expand(B, n, n),
                     A_masked.mT], dim=-1)
    bottom = torch.cat([A_masked, (-delta * torch.eye(m, **like)).expand(
        B, m, m)], dim=-1)
    LU, piv, info = torch.linalg.lu_factor_ex(torch.cat([top, bottom], dim=-2))
    LU = _nan_where_failed(LU, info, float("nan"))

    def lu_solve(b):
        return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]

    sol = lu_solve(rhs)
    for _ in range(settings.polish_refine_iters):
        # iterative refinement against the UNregularised KKT operator
        xs, ys = sol[..., :n], sol[..., n:]
        r_top = -data.q - (_mv(data.P, xs) + _mtv(A_masked, ys))
        r_bot = b_act - _mv(A_masked, xs)
        sol = sol + lu_solve(torch.cat([r_top, r_bot], dim=-1))
    x_p = sol[..., :n]
    y_p = torch.where(active, sol[..., n:], 0.0)
    z_p = _clip(_mv(data.A, x_p), data.l, data.u)

    pri0, dua0, _, _ = _residuals(data, x, z, y)
    pri1, dua1, _, _ = _residuals(data, x_p, z_p, y_p)
    better = ((pri1 + dua1) < (pri0 + dua0))[..., None]
    return (torch.where(better, x_p, x), torch.where(better, z_p, z),
            torch.where(better, y_p, y))


def _warm_start(data: QPData, x0, y0):
    """Scaled, sanitised warm start (x, z, y). Warm starts are carried
    across 200 Hz ticks even when a solve fails: one non-finite iterate must
    not poison every later tick."""
    d, e, c = data.scaling
    B, n, m = data.q.shape[0], data.P.shape[-1], data.A.shape[-2]
    like = dict(dtype=data.q.dtype, device=data.q.device)
    x = torch.zeros((B, n), **like) if x0 is None else x0 / d
    y = torch.zeros((B, m), **like) if y0 is None else y0 * c[..., None] / e
    x = torch.where(torch.isfinite(x), x, 0.0)
    y = torch.where(torch.isfinite(y), y, 0.0)
    return x, _clip(_mv(data.A, x), data.l, data.u), y


def _rho_ratio(settings: ADMMSettings, pri, dua, pri_s, dua_s):
    return torch.sqrt((pri / torch.clamp_min(pri_s, 1e-12))
                      / torch.clamp_min(dua / torch.clamp_min(dua_s, 1e-12),
                                        1e-12))


def _status(settings: ADMMSettings, data: QPData, x, z, y, pinf=None,
            dinf=None):
    pri, dua, pri_s, dua_s = _residuals(data, x, z, y)
    eps_pri = settings.eps_abs + settings.eps_rel * pri_s
    eps_dua = settings.eps_abs + settings.eps_rel * dua_s
    solved = (pri <= eps_pri) & (dua <= eps_dua)
    inacc = (pri <= 10.0 * eps_pri) & (dua <= 10.0 * eps_dua)
    status = torch.where(solved, SOLVED,
                         torch.where(inacc, SOLVED_INACCURATE,
                                     MAX_ITER_REACHED))
    if pinf is not None:
        status = torch.where(pinf, PRIMAL_INFEASIBLE,
                             torch.where(dinf, DUAL_INFEASIBLE, status))
    return status.to(torch.int32), pri, dua


def _solution(data: QPData, x, z, y, status, iterations, pri, dua):
    d, e, c = data.scaling
    return QPSolution(x=x * d, y=y * e / c[..., None], z=z / e,
                      status=status, iterations=iterations, pri_res=pri,
                      dua_res=dua)


def solve_prepared(data: QPData, settings: ADMMSettings = ADMMSettings(),
                   x0=None, y0=None) -> QPSolution:
    """ADMM on prepared data with a fixed iteration count: a Python loop
    that reads nothing back, the lanes in lockstep.

    Warm-start vectors ``x0, y0`` are in *unscaled* units (as stored across
    MPC ticks); pass None for cold start. ρ is re-tuned per lane at the
    static marks ``settings.rho_update_iters`` and K re-factorised for every
    lane; the infeasibility flags are sticky."""
    B = data.q.shape[0]
    x, z, y = _warm_start(data, x0, y0)
    pinf = torch.zeros((B,), dtype=torch.bool, device=x.device)
    dinf = torch.zeros_like(pinf)
    marks = [i for i in settings.rho_update_iters if i < settings.max_iter]
    bounds = [0] + marks + [settings.max_iter]
    rho_scalar = torch.full((B,), settings.rho, dtype=x.dtype, device=x.device)
    data_k = data
    for seg in range(len(bounds) - 1):
        for _ in range(bounds[seg + 1] - bounds[seg]):
            x_n, z_n, y_n = _iterate(data_k, settings, x, z, y)
            p, dn = _infeasibility_certificates(data_k, x_n - x, y_n - y,
                                                settings)
            x, z, y = x_n, z_n, y_n
            pinf, dinf = pinf | p, dinf | dn
        if seg < len(bounds) - 2:
            ratio = _rho_ratio(settings, *_residuals(data_k, x, z, y))
            new_rho = torch.clamp(rho_scalar * ratio, settings.rho_min,
                                  settings.rho_max)
            tol = settings.adaptive_rho_tolerance
            update = (ratio > tol) | (ratio < 1.0 / tol)
            rho_scalar = torch.where(update, new_rho, rho_scalar)
            rho_vec = rho_vector(data.l, data.u, settings, rho_scalar)
            data_k = data._replace(rho_vec=rho_vec, chol_K=factorize(
                data.P, data.A, rho_vec, settings.sigma))

    if settings.polish:
        x, z, y = polish(data, settings, x, z, y)
    status, pri, dua = _status(settings, data, x, z, y, pinf, dinf)
    iterations = torch.full((B,), settings.max_iter, dtype=torch.int32,
                            device=x.device)
    return _solution(data, x, z, y, status, iterations, pri, dua)


def solve(P, q, A, l, u, settings: ADMMSettings = ADMMSettings(),
          x0=None, y0=None, scaling: Optional[Scaling] = None) -> QPSolution:
    """Convenience one-shot: prepare + solve, every lane."""
    data = prepare(P, q, A, l, u, settings, scaling)
    return solve_prepared(data, settings, x0, y0)


def solve_adaptive(P, q, A, l, u, settings: ADMMSettings = ADMMSettings(),
                   x0=None, y0=None, scaling: Optional[Scaling] = None,
                   check_every: int = 25) -> QPSolution:
    """Early-exit variant: checks convergence every ``check_every``
    iterations and stops a lane as soon as the OSQP termination criterion
    holds, re-tuning its ρ between checks while it runs.

    As ``lax.while_loop`` under ``vmap``: the loop runs while any lane is
    running (one host read-back a check), every lane computes, and a
    finished lane keeps its state and its count of ``iterations``."""
    data = prepare(P, q, A, l, u, settings, scaling)
    B = data.q.shape[0]
    x, z, y = _warm_start(data, x0, y0)
    dev = x.device
    rho_s = torch.full((B,), settings.rho, dtype=x.dtype, device=dev)
    chol = data.chol_K
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    tol = settings.adaptive_rho_tolerance
    while True:
        running = ~done & (it < settings.max_iter)
        if not bool(running.any()):
            break
        data_k = data._replace(
            rho_vec=rho_vector(data.l, data.u, settings, rho_s), chol_K=chol)
        xn, zn, yn = x, z, y
        for _ in range(check_every):
            xn, zn, yn = _iterate(data_k, settings, xn, zn, yn)
        pri, dua, pri_s, dua_s = _residuals(data, xn, zn, yn)
        done_n = ((pri <= settings.eps_abs + settings.eps_rel * pri_s)
                  & (dua <= settings.eps_abs + settings.eps_rel * dua_s))
        ratio = _rho_ratio(settings, pri, dua, pri_s, dua_s)
        update = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done_n
        rho_n = torch.where(update, torch.clamp(rho_s * ratio,
                                                settings.rho_min,
                                                settings.rho_max), rho_s)
        chol_n = torch.where(update[:, None, None], factorize(
            data.P, data.A, rho_vector(data.l, data.u, settings, rho_n),
            settings.sigma), chol)
        run_v = running[:, None]
        x = torch.where(run_v, xn, x)
        z = torch.where(run_v, zn, z)
        y = torch.where(run_v, yn, y)
        rho_s = torch.where(running, rho_n, rho_s)
        chol = torch.where(running[:, None, None], chol_n, chol)
        it = torch.where(running, it + check_every, it)
        done = torch.where(running, done_n, done)

    if settings.polish:
        x, z, y = polish(data, settings, x, z, y)
    status, pri, dua = _status(settings, data, x, z, y)
    return _solution(data, x, z, y, status, it, pri, dua)
