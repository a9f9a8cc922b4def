"""Tensor-parallel ADMM: constraint rows sharded over the mesh's ``"kkt"``
axis (counterpart of ``ironcub_mpc_tpu/parallel/tp_admm.py``).

The ADMM operator's tall constraint matrix is split by rows over the ranks
of a kkt group: ``A x`` needs no communication (each rank owns its rows),
while ``Aᵀ v`` and the reduced-KKT formation ``AᵀρA`` become one
``all_reduce(SUM)`` each over the group (JAX's ``psum``), and the residual
norms an ``all_reduce(MAX)`` (``pmax``). The x-update is replicated (the
588×588 Cholesky is cheap); z/y updates stay local to each rank.

The arithmetic is JAX's ``solve_tp`` line for line: Ruiz equilibration with
collective column norms and a cost scaling per iteration, one Cholesky of
K, a fixed ``max_iter`` iterations with no early exit and no adaptive ρ,
the unscaled residuals and the SOLVED / SOLVED_INACCURATE / MAX_ITER
status. Polish is not supported in the sharded path (the dense KKT
assembly would defeat the sharding). Every tensor keeps the port's leading
lane dimension (one QP is B = 1) and every reduction runs over a lane's own
axes. The Cholesky and the triangular solves are stock fp32
``torch.linalg`` (XLA ops in JAX: no Pallas kernel on this path).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F_

from ..ops import admm
from .mesh import Mesh


def pad_rows(A, l, u, parts: int):
    """Pad constraint rows (the last-but-one axis of ``A``, the last of
    ``l``/``u``) to a multiple of ``parts`` with 0 ≤ 0 ≤ 0 rows; returns
    (A, l, u, m) with m the original row count."""
    m = A.shape[-2]
    m_pad = (-m) % parts
    if m_pad:
        A = F_.pad(A, (0, 0, 0, m_pad))
        l = F_.pad(l, (0, m_pad))
        u = F_.pad(u, (0, m_pad))
    return A, l, u, m


def solve_tp(P_mat, q, A, l, u, mesh: Mesh | None = None,
             settings: admm.ADMMSettings = admm.ADMMSettings(polish=False)
             ) -> admm.QPSolution:
    """Row-sharded ADMM solve of min ½xᵀPx + qᵀx s.t. l ≤ Ax ≤ u for every
    lane: P ([n, n] or [B, n, n]) and q ([B, n]) replicated, A ([m, n] or
    [B, m, n]), l, u ([B, m]) cut by rows over ``mesh``'s kkt group, as
    ``P("kkt")`` cuts them. Every rank of the group calls it with the same
    inputs.

    Returns an :class:`~ironcub_mpc_tpu_torch.ops.admm.QPSolution` on every
    rank: x replicated, y and z gathered over the group and cut back to m,
    ``iterations = max_iter``. ``settings.polish`` is not read: the
    sharded path never polishes, as in JAX. With ``mesh=None`` or a kkt
    size of 1 it is the same arithmetic with no collectives."""
    group = None if mesh is None else mesh.kkt_group
    parts = 1 if group is None else mesh.n_kkt
    index = 0 if group is None else mesh.kkt_index
    A_p, l_p, u_p, m_orig = pad_rows(A, l, u, parts)
    rows = A_p.shape[-2] // parts
    cut = slice(index * rows, (index + 1) * rows)
    A_s, l_s, u_s = A_p[..., cut, :], l_p[..., cut], u_p[..., cut]

    def psum(v):
        if group is not None:
            v = v.contiguous()
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
        return v

    def pmax(v):
        if group is not None:
            v = v.contiguous()
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
        return v

    def amax(v):
        return v.abs().amax(dim=-1)

    s = settings
    B, n = q.shape[0], P_mat.shape[-1]
    like = dict(dtype=q.dtype, device=q.device)

    # --- Ruiz equilibration with collective column norms -----------------
    D = torch.ones((B, n), **like)
    E_s = torch.ones(l_s.shape, **like)
    c = torch.ones((B,), **like)
    Pm, qv, As, ls, us = P_mat, q, A_s, l_s, u_s
    for _ in range(s.scaling_iters):
        colP = Pm.abs().amax(dim=-2)
        colA = pmax(As.abs().amax(dim=-2).expand(B, n))
        d = admm._safe_inv_sqrt(torch.maximum(colP, colA))
        e = admm._safe_inv_sqrt(As.abs().amax(dim=-1))
        Pm = d[..., :, None] * Pm * d[..., None, :]
        qv = d * qv
        As = e[..., :, None] * As * d[..., None, :]
        ls, us = e * ls, e * us
        D, E_s = D * d, E_s * e
        g = 1.0 / torch.clamp(torch.maximum(
            Pm.abs().amax(dim=-2).mean(dim=-1), amax(qv)), 1e-8, 1e8)
        Pm, qv, c = g[:, None, None] * Pm, g[:, None] * qv, c * g

    rho_s = admm.rho_vector(ls, us, s)
    K = Pm + s.sigma * torch.eye(n, **like)
    K = K + psum(As.mT @ (rho_s[..., :, None] * As))
    chol = admm.cholesky(K)

    x = torch.zeros((B, n), **like)
    y_s = torch.zeros(ls.shape, **like)
    z_s = admm._clip(admm._mv(As, x), ls, us)
    for _ in range(s.max_iter):
        rhs = s.sigma * x - qv + psum(admm._mtv(As, rho_s * z_s - y_s))
        x_t = admm._cho_solve(chol, rhs)
        z_t = admm._mv(As, x_t)
        x_n = s.alpha * x_t + (1 - s.alpha) * x
        z_rel = s.alpha * z_t + (1 - s.alpha) * z_s
        z_un = z_rel + y_s / rho_s
        z_n = admm._clip(z_un, ls, us)
        y_s = rho_s * (z_un - z_n)
        x, z_s = x_n, z_n

    # unscaled residuals (collective norms); the termination semantics of
    # ops/admm.solve_prepared: primal AND dual tests, with the 10x-relaxed
    # SOLVED_INACCURATE tier
    Aty = psum(admm._mtv(As, y_s))
    Ax = admm._mv(As, x)
    pri, ax_scale, z_scale = pmax(torch.stack([
        amax((Ax - z_s) / E_s), amax(Ax / E_s), amax(z_s / E_s)])).unbind()
    Px = admm._mv(Pm, x)
    dua = amax((Px + qv + Aty) / D) / c
    pri_scale = torch.maximum(ax_scale, z_scale)
    dua_scale = torch.maximum(torch.maximum(amax(Px / D), amax(Aty / D)),
                              amax(qv / D)) / c
    eps_pri = s.eps_abs + s.eps_rel * pri_scale
    eps_dua = s.eps_abs + s.eps_rel * dua_scale
    solved = (pri <= eps_pri) & (dua <= eps_dua)
    inacc = (pri <= 10 * eps_pri) & (dua <= 10 * eps_dua)
    status = torch.where(solved, admm.SOLVED,
                         torch.where(inacc, admm.SOLVED_INACCURATE,
                                     admm.MAX_ITER_REACHED))

    def gather(v):
        """Every rank's rows, in row order, cut back to m."""
        if group is not None:
            blocks = [torch.empty_like(v) for _ in range(parts)]
            dist.all_gather(blocks, v.contiguous(), group=group)
            v = torch.cat(blocks, dim=-1)
        return v[..., :m_orig]

    return admm.QPSolution(
        x=x * D, y=gather(y_s * E_s / c[:, None]), z=gather(z_s / E_s),
        status=status.to(torch.int32),
        iterations=torch.full((B,), s.max_iter, dtype=torch.int32,
                              device=q.device),
        pri_res=pri, dua_res=dua)
