"""The multi-rate MPC tick (counterpart of ``ironcub_mpc_tpu/qp/mpc.py``).

``configure`` builds the constant problem, the initial reference window,
the setup-time equilibration and the initial carry; ``mpc_tick`` is one
200 Hz controller step — reference-window shift, linearisation, QP build,
warm-started solve, command extraction — as a function
``(carry, snapshot) -> (carry', output)`` on batched tensors. The problem
is shared by every lane; carry, snapshot and output carry a leading batch
dimension B.

Solve strategy per ``cfg.qp_solver``: "condensed" eliminates the states
exactly into a 120-input box QP solved with a carried K⁻¹ and the
hand-written kernels; "full" solves the 588 × 512 form with the OSQP
scheme of :mod:`ironcub_mpc_tpu_torch.ops.admm`, as the reference does.
With ``cfg.enable_debug_log_mode`` each output carries a
:class:`~ironcub_mpc_tpu_torch.core.types.DebugInfo`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import constants as C
from ..core.config import MPCConfig
from ..core.types import (DebugInfo, MPCCarry, MPCOutput, RobotSnapshot,
                          const_tensor, index_tensor)
from ..horizon.schedule import HorizonSchedule
from ..ops import admm
from ..ops import jet_model as jm
from ..ops.so3 import euler_rate_matrix, matrix_to_rpy, unwrap_rpy
from . import assembly
from . import condensed
from .blocks import LambdaInit, LinearizedDynamics, linearize


class MPCProblem(NamedTuple):
    """Tensors fixed at configure time (no batch dimension)."""

    H: torch.Tensor                   # [n_var, n_var] constant Hessian
    H_u: torch.Tensor                 # [nU, nU] constant input-space Hessian
    Q: torch.Tensor                   # [26, 26] state weight block
    lambda_init: LambdaInit
    joint_pos_ref_ctrl: torch.Tensor  # [n_ctrl] initial posture of controlled joints
    com_pos_init: torch.Tensor        # [3] CoM at configure (trajectory offset)
    rpy_init: torch.Tensor            # [3] RPY at configure (trajectory offset)
    traj_pos: torch.Tensor            # [T, 3] positionCoM channel
    traj_vel: torch.Tensor            # [T, 3] velocityCoM
    traj_rpy: torch.Tensor            # [T, 3] RPY
    traj_rpydot: torch.Tensor         # [T, 3] RPYDot
    alpha_traj: torch.Tensor          # [Ta] alphaGravity at MPC rate
    scaling: admm.Scaling             # full-space Ruiz scaling (identity
                                      # for the condensed solver)
    # frozen condensed-space equilibration (None for the full-space solver)
    cond_scaling: condensed.CondensedScaling = None


class TickPrep(NamedTuple):
    state_ref: torch.Tensor           # [B, 26, nIter]
    lin: LinearizedDynamics
    x0: torch.Tensor                  # [B, 26]
    pin: torch.Tensor                 # [B] bool


# ---------------------------------------------------------------------------
# reference window
# ---------------------------------------------------------------------------


def _window_column(problem: MPCProblem, snap: RobotSnapshot, idx):
    """One new reference column per lane at trajectory cursor ``idx`` [B]:
    pos = c₀ + p_ref; h_lin = Rᵀ m v_ref; rpy = φ₀ + φ_ref;
    h_ang = I_lock W(φ) φ̇_ref, with R, I, W from the measured state."""
    i = torch.clamp(idx, 0, problem.traj_pos.shape[0] - 1).long()
    R = snap.w_R_b
    p = problem.com_pos_init + problem.traj_pos[i]
    lin = (R.mT @ (snap.total_mass[:, None] * problem.traj_vel[i])[..., None]
           )[..., 0]
    rpy_col = problem.rpy_init + problem.traj_rpy[i]
    W = euler_rate_matrix(matrix_to_rpy(R))
    ang = (snap.inertia_locked @ (W @ problem.traj_rpydot[i][..., None]))[..., 0]
    return p, lin, rpy_col, ang


def _shift_window(win, new_col):
    return torch.cat([win[:, :, 1:], new_col[:, :, None]], dim=-1)


def _advance_ref(cfg: MPCConfig, problem: MPCProblem, carry: MPCCarry,
                 snap: RobotSnapshot):
    """Every ratio-th tick: advance the trajectory cursor, shift the rolling
    window and refresh the current reference."""
    shift = carry.ref_counter == (cfg.ratio_small_large - 1)
    idx_next = torch.clamp_max(carry.pos_traj_idx + 1,
                               problem.traj_pos.shape[0] - 1)
    p, lin, rpy_col, ang = _window_column(problem, snap, idx_next)
    sw = shift[:, None, None]
    pos_w = torch.where(sw, _shift_window(carry.pos_com_ref, p),
                        carry.pos_com_ref)
    lin_w = torch.where(sw, _shift_window(carry.lin_mom_ref, lin),
                        carry.lin_mom_ref)
    rpy_w = torch.where(sw, _shift_window(carry.rpy_ref, rpy_col),
                        carry.rpy_ref)
    ang_w = torch.where(sw, _shift_window(carry.ang_mom_ref, ang),
                        carry.ang_mom_ref)
    sv = shift[:, None]
    return carry._replace(
        pos_com_ref=pos_w, lin_mom_ref=lin_w, rpy_ref=rpy_w, ang_mom_ref=ang_w,
        pos_com_ref_now=torch.where(sv, pos_w[:, :, 0], carry.pos_com_ref_now),
        rpy_ref_now=torch.where(sv, rpy_w[:, :, 0], carry.rpy_ref_now),
        mom_ref_now=torch.where(
            sv, torch.cat([lin_w[:, :, 0], ang_w[:, :, 0]], dim=-1),
            carry.mom_ref_now),
        pos_traj_idx=torch.where(shift, idx_next, carry.pos_traj_idx),
        ref_counter=torch.where(shift, torch.zeros_like(carry.ref_counter),
                                carry.ref_counter + 1),
    )


def _initial_state(cfg: MPCConfig, carry: MPCCarry, snap: RobotSnapshot,
                   est_thrust_dot):
    """x0 [B, 26] with the RPY unwrapped against the carried raw angles."""
    rpy_raw = matrix_to_rpy(snap.w_R_b)
    rpy_unwrapped, n_turns = unwrap_rpy(rpy_raw, carry.rpy_old, carry.n_turns)
    if cfg.use_estimated_thrust:
        thrust, thrust_dot = snap.jet_thrusts, est_thrust_dot
    else:
        thrust, thrust_dot = carry.thrust_des, carry.thrust_dot_des
    x0 = torch.cat([snap.com_pos, snap.momentum_body[:, :3], rpy_unwrapped,
                    snap.momentum_body[:, 3:], thrust, thrust_dot,
                    snap.com_pos - carry.pos_com_ref_now,
                    rpy_unwrapped - carry.rpy_ref_now], dim=-1)
    return x0, rpy_raw, n_turns


# ---------------------------------------------------------------------------
# debug-log mode (IMPCProblem.cpp:300-408: per-block ½xᵀHx+gᵀx and
# lb ≤ Ax ≤ ub triples, zeroed on non-solved lanes)
# ---------------------------------------------------------------------------


def _block_costs(cfg: MPCConfig, q_diag, states, state_ref, u,
                 joint_reg_grad, throttle_init_grad):
    """Per-cost-block ½xᵀH_b x + g_bᵀx values [B, 4], registration order
    (variableSamplingMPC.cpp:70-76): tracking, joint and throttle-rate
    regularisation, initial throttle, joint position. ``states``
    [B, nIter, 26] are knots 1..nIter, ``state_ref`` [B, 26, nIter]."""
    nj, nt, ch = cfg.n_ctrl_joints, cfg.n_jets, cfg.control_horizon
    B = u.shape[0]
    tracking = ((0.5 * states - state_ref.mT) * q_diag * states).sum((-2, -1))
    dq = u[:, :nj * ch].reshape(B, ch, nj)
    wj = const_tensor(tuple(cfg.weight_delta_joint), u.dtype, u.device)
    reg = 0.5 * (dq * dq * wj).sum((-2, -1))
    v = u[:, nj * ch:].reshape(B, -1, nt)
    dv = v[:, 1:] - v[:, :-1]
    reg = reg + 0.5 * cfg.weight_throttle * (dv * dv).sum((-2, -1))
    thr0 = (0.5 * cfg.weight_initial_throttle * (v[:, 0] * v[:, 0]).sum(-1)
            + (throttle_init_grad * v[:, 0]).sum(-1))
    jreg = (0.5 * cfg.weight_regularization_joint_pos * (dq * dq).sum((-2, -1))
            + (joint_reg_grad[:, None, :] * dq).sum((-2, -1)))
    return torch.stack([tracking, reg, thr0, jreg], dim=-1)


def _solved(status):
    return (status == admm.SOLVED) | (status == admm.SOLVED_INACCURATE)


def _debug_info(costs, lb, ax, ub, status) -> DebugInfo:
    solved = _solved(status)[:, None]
    costs = torch.where(solved, costs, 0.0)
    return DebugInfo(total_cost=costs.sum(-1), block_costs=costs,
                     constraint_lb=lb, constraint_ax=torch.where(solved, ax,
                                                                 0.0),
                     constraint_ub=ub)


def _debug_condensed(cfg: MPCConfig, sched, prep, qp, csol, q_diag,
                     joint_reg_grad, throttle_init_grad) -> DebugInfo:
    """Triples for the condensed path without re-assembling A: dynamics and
    initial-state equalities hold exactly by construction of the
    elimination, so their Ax equals the bound; box rows carry the true
    iterate. Row order and padding match the reference stack
    (IMPCProblem.cpp:83-134, constraintsVSMPC.cpp:283 zero-row quirk)."""
    u = csol.u
    B, dt_, dev = u.shape[0], u.dtype, u.device
    dts = const_tensor(tuple(sched.dts), dt_, dev)
    b_dyn = (-dts[:, None] * prep.lin.c[:, None, :]).reshape(B, -1)
    n_tk = cfg.n_jets * cfg.n_throttle_knots
    pad = torch.zeros((B, cfg.n_throttle_constraints - n_tk), dtype=dt_,
                      device=dev)
    lbs = [b_dyn, prep.x0, qp.lb[:, -n_tk:], pad]
    ubs = [b_dyn, prep.x0, qp.ub[:, -n_tk:], pad]
    axs = [b_dyn, prep.x0, u[:, -n_tk:], pad]
    if cfg.use_joint_position_constraint:
        njc = cfg.n_ctrl_joints * cfg.control_horizon
        padj = torch.zeros((B, cfg.n_joint_position_constraints - njc),
                           dtype=dt_, device=dev)
        lbs += [qp.lb[:, :njc], padj]
        ubs += [qp.ub[:, :njc], padj]
        axs += [u[:, :njc], padj]
    costs = _block_costs(cfg, q_diag, csol.states, prep.state_ref, u,
                         joint_reg_grad, throttle_init_grad)
    return _debug_info(costs, torch.cat(lbs, -1), torch.cat(axs, -1),
                       torch.cat(ubs, -1), csol.status)


def _debug_full(cfg: MPCConfig, problem, prep, x, A, lb, ub, status,
                joint_reg_grad, throttle_init_grad) -> DebugInfo:
    ns = cfg.n_states
    states = x[:, ns:ns * (cfg.n_iter + 1)].reshape(-1, cfg.n_iter, ns)
    costs = _block_costs(cfg, torch.diagonal(problem.Q), states,
                         prep.state_ref, x[:, cfg.joints_offset:],
                         joint_reg_grad, throttle_init_grad)
    return _debug_info(costs, lb, (A @ x[..., None])[..., 0], ub, status)


# ---------------------------------------------------------------------------
# one tick
# ---------------------------------------------------------------------------


def _tick_prep(cfg, joint_sel, problem: MPCProblem, carry: MPCCarry,
               snap: RobotSnapshot, est_thrust_dot):
    """Reference shift, linearisation, initial state and the multi-rate
    throttle counter (costs first, then constraints, as the reference)."""
    carry = _advance_ref(cfg, problem, carry, snap)
    state_ref = assembly.build_state_reference(
        cfg, carry.pos_com_ref, carry.lin_mom_ref, carry.rpy_ref,
        carry.ang_mom_ref)
    # alphaGravity: read-then-advance each linearisation
    n_alpha = problem.alpha_traj.shape[0]
    alpha = problem.alpha_traj[
        torch.clamp(carry.alpha_traj_idx, 0, n_alpha - 1).long()]
    alpha_idx = torch.clamp_max(carry.alpha_traj_idx + 1, n_alpha - 1)
    lin = linearize(
        cfg, snap, problem.lambda_init, joint_sel,
        alpha_gravity=alpha, pos_com_ref_now=carry.pos_com_ref_now,
        est_thrust_dot=est_thrust_dot, thrust_des=carry.thrust_des,
        thrust_dot_des=carry.thrust_dot_des, throttle_cmd=carry.throttle_cmd)
    x0, rpy_raw, n_turns = _initial_state(cfg, carry, snap, est_thrust_dot)
    # throttle pin & counter: the first throttle knot is pinned to the
    # applied throttle except on every ratio-th tick
    last = cfg.ratio_small_large - 1
    pin = carry.throttle_counter != last
    throttle_counter = torch.where(carry.throttle_counter == last,
                                   torch.zeros_like(carry.throttle_counter),
                                   carry.throttle_counter + 1)
    carry = carry._replace(
        rpy_old=rpy_raw, n_turns=n_turns, alpha_traj_idx=alpha_idx,
        alpha_gravity=alpha, throttle_counter=throttle_counter)
    return carry, TickPrep(state_ref=state_ref, lin=lin, x0=x0, pin=pin)


def _tick_gradients(cfg, sel, problem: MPCProblem, carry: MPCCarry):
    """The joint-regularisation and initial-throttle gradients of the QP
    built from ``carry``."""
    joint_reg_grad = cfg.weight_regularization_joint_pos * (
        carry.joints_pos_ref[:, sel] - problem.joint_pos_ref_ctrl)
    throttle_init_grad = (-cfg.weight_initial_throttle
                          * jm.throttle_to_v(carry.throttle_cmd))
    return joint_reg_grad, throttle_init_grad


def condense_from_prep(cfg: MPCConfig, sched, joint_sel,
                       problem: MPCProblem, carry: MPCCarry, prep: TickPrep):
    """Per-tick gradients + exact state elimination."""
    sel = index_tensor(tuple(joint_sel), carry.joints_pos_ref.device)
    q_diag = torch.diagonal(problem.Q)
    joint_reg_grad, throttle_init_grad = _tick_gradients(cfg, sel, problem,
                                                         carry)
    qp = condensed.condense(
        cfg, sched, prep.lin, prep.x0, prep.state_ref, q_diag,
        problem.H_u, joint_reg_grad, throttle_init_grad, prep.pin,
        carry.throttle_cmd, joint_pos_ctrl=carry.joints_pos_ref[:, sel])
    return qp, q_diag, joint_reg_grad, throttle_init_grad


def solve_condensed(cfg: MPCConfig, settings: admm.ADMMSettings,
                    problem: MPCProblem, carry: MPCCarry,
                    qp: condensed.CondensedQP) -> condensed.CondensedSolution:
    """The warm-started box-QP solve."""
    use_carry = settings.kinv_carry and not settings.kinv_reset
    return condensed.solve(
        cfg, qp, settings, warm_u=carry.warm_x, warm_y=carry.warm_y,
        scaling=problem.cond_scaling,
        kinv_prev=carry.kinv if use_carry else None,
        rho_prev=carry.rho_vec if use_carry else None,
        rho_scalar_prev=carry.rho_scalar if use_carry else None)


def _assemble(cfg, sched, joint_sel, problem: MPCProblem, carry: MPCCarry,
              snap: RobotSnapshot, est_thrust_dot):
    """Full-space gradient + constraint stack for the current tick."""
    carry, prep = _tick_prep(cfg, joint_sel, problem, carry, snap,
                             est_thrust_dot)
    jp = carry.joints_pos_ref[:, index_tensor(tuple(joint_sel),
                                              carry.joints_pos_ref.device)]
    g = assembly.build_gradient(cfg, problem.Q, prep.state_ref, jp,
                                problem.joint_pos_ref_ctrl, carry.throttle_cmd)
    A, lb, ub = assembly.assemble_constraints(
        cfg, sched, prep.lin, prep.x0, prep.pin, carry.throttle_cmd,
        joint_pos_ctrl=jp)
    return g, A, lb, ub, carry, prep


def mpc_tick(cfg: MPCConfig, sched: HorizonSchedule, joint_sel: Tuple[int, ...],
             settings: admm.ADMMSettings, problem: MPCProblem,
             carry: MPCCarry, snap: RobotSnapshot,
             est_thrust_dot) -> Tuple[MPCCarry, MPCOutput]:
    """One 200 Hz multi-rate MPC step for every lane: update + solve +
    extract. ``est_thrust_dot`` is [B, 4]."""
    if cfg.qp_solver == "condensed":
        carry, prep = _tick_prep(cfg, joint_sel, problem, carry, snap,
                                 est_thrust_dot)
        qp = condense_from_prep(cfg, sched, joint_sel, problem, carry,
                                prep)[0]
        csol = solve_condensed(cfg, settings, problem, carry, qp)
        return extract_condensed(cfg, joint_sel, carry, csol, settings,
                                 problem, sched, prep, qp)
    nj, nt = cfg.n_ctrl_joints, cfg.n_jets
    sel = index_tensor(tuple(joint_sel), carry.joints_pos_ref.device)
    g, A, lb, ub, carry, prep = _assemble(cfg, sched, joint_sel, problem,
                                          carry, snap, est_thrust_dot)
    data = admm.prepare(problem.H, g, A, lb, ub, settings,
                        scaling=problem.scaling)
    sol = admm.solve_prepared(data, settings, x0=carry.warm_x,
                              y0=carry.warm_y)
    debug = None
    if cfg.enable_debug_log_mode:
        debug = _debug_full(cfg, problem, prep, sol.x, A, lb, ub, sol.status,
                            *_tick_gradients(cfg, sel, problem, carry))
    # extraction (variableSamplingMPC.cpp:88-112)
    ns, x = cfg.n_states, sol.x
    jo, to = cfg.joints_offset, cfg.throttle_offset
    return _finish_tick(
        cfg, sel, carry, x[:, jo:jo + nj], x[:, to:to + nt],
        x[:, ns + C.THRUST0:ns + C.THRUST0 + 4],
        x[:, ns + C.THRUST_DOT0:ns + C.THRUST_DOT0 + 4],
        x[:, ns * cfg.n_iter:ns * (cfg.n_iter + 1)], sol.status, sol.pri_res,
        sol.dua_res, sol.x, sol.y,
        torch.zeros_like(sol.status, dtype=torch.bool), debug)


def _finish_tick(cfg, sel, carry: MPCCarry, delta_joints, throttle_v,
                 thrust_des, thrust_dot_des, final_state, status, pri_res,
                 dua_res, warm_x, warm_y, guard_fired, debug=None):
    """Command integration + output assembly: joint deltas integrate into
    the absolute reference, throttle destandardises; non-solved lanes keep
    their previous commands."""
    solved = (status == admm.SOLVED)[:, None]
    joints_new = carry.joints_pos_ref.clone()
    joints_new[:, sel] += delta_joints
    throttle_new = jm.destandardize_throttle(throttle_v)

    def pick(new, old):
        return torch.where(solved, new, old)

    carry = carry._replace(
        joints_pos_ref=pick(joints_new, carry.joints_pos_ref),
        throttle_cmd=pick(throttle_new, carry.throttle_cmd),
        thrust_des=pick(thrust_des, carry.thrust_des),
        thrust_dot_des=pick(thrust_dot_des, carry.thrust_dot_des),
        warm_x=warm_x, warm_y=warm_y,
    )
    out = MPCOutput(
        joints_pos_ref=carry.joints_pos_ref,
        throttle=carry.throttle_cmd,
        thrust_des=carry.thrust_des,
        thrust_dot_des=carry.thrust_dot_des,
        final_state=final_state,
        status=status, pri_res=pri_res, dua_res=dua_res,
        alpha_gravity=carry.alpha_gravity,
        pos_com_ref=carry.pos_com_ref_now,
        rpy_ref=carry.rpy_ref_now,
        mom_ref=carry.mom_ref_now,
        guard_fired=guard_fired,
        debug=debug,
    )
    return carry, out


def extract_condensed(cfg: MPCConfig, joint_sel, carry: MPCCarry,
                      csol: condensed.CondensedSolution,
                      settings: admm.ADMMSettings,
                      problem: MPCProblem = None,
                      sched: HorizonSchedule = None, prep: TickPrep = None,
                      qp: condensed.CondensedQP = None):
    """The tail of the condensed tick: solution slicing + command
    integration (``mpc_tick`` ends with it, and so can a runner that solves
    the QP as a stage of its own).

    When ``enable_debug_log_mode`` is on, pass ``problem``/``sched``/
    ``prep``/``qp`` so the per-block DebugInfo is emitted exactly like the
    monolithic tick; otherwise ``out.debug`` is None."""
    nj, nt = cfg.n_ctrl_joints, cfg.n_jets
    sel = index_tensor(tuple(joint_sel), carry.joints_pos_ref.device)
    debug = None
    if cfg.enable_debug_log_mode and qp is not None:
        # the gradients of condense_from_prep, from the carry the QP was
        # built from
        debug = _debug_condensed(cfg, sched, prep, qp, csol,
                                 torch.diagonal(problem.Q),
                                 *_tick_gradients(cfg, sel, problem, carry))
    if settings.kinv_carry:
        carry = carry._replace(kinv=csol.kinv, rho_vec=csol.rho_vec,
                               rho_scalar=csol.rho_scalar)
    to = nj * cfg.control_horizon
    return _finish_tick(
        cfg, sel, carry, csol.u[:, :nj], csol.u[:, to:to + nt],
        csol.states[:, 0, C.THRUST], csol.states[:, 0, C.THRUST_DOT],
        csol.states[:, -1], csol.status, csol.pri_res, csol.dua_res,
        csol.u, csol.y, csol.guard_fired, debug)


# ---------------------------------------------------------------------------
# configure
# ---------------------------------------------------------------------------


def configure(cfg: MPCConfig, sched: HorizonSchedule,
              joint_sel: Tuple[int, ...], snap0: RobotSnapshot,
              traj_channels: dict, alpha_traj,
              settings: admm.ADMMSettings = admm.ADMMSettings(),
              est_thrust_dot=None, initial_throttle=None, device=None,
              dtype=torch.float32) -> Tuple[MPCProblem, MPCCarry]:
    """Build problem constants and the initial one-lane carry.

    ``snap0`` is a one-lane snapshot (leading dimension 1). As the
    reference's configure, the first compute runs here: it advances the
    reference window and the alphaGravity cursor once and computes the
    equilibration from the first QP: the frozen condensed scaling and the
    initial (K(ρ))⁻¹ for the condensed solver, the Ruiz scaling of the
    full-space QP (``problem.scaling``, no carried inverse) for the full
    one. Runs on ``cuda`` unless ``device`` says otherwise.
    """
    dev = resolve_device(device)

    def f(a):
        if isinstance(a, torch.Tensor):
            # flags (the snapshot's on_ground) keep their type
            return (a.to(device=dev, dtype=dtype) if a.is_floating_point()
                    else a.to(device=dev))
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    snap0 = RobotSnapshot(*(None if t is None else f(t) for t in snap0))
    est_thrust_dot = (torch.zeros((1, 4), dtype=dtype, device=dev)
                      if est_thrust_dot is None else f(est_thrust_dot).reshape(1, 4))
    initial_throttle = (torch.zeros((1, 4), dtype=dtype, device=dev)
                        if initial_throttle is None
                        else f(initial_throttle).reshape(1, 4))

    rpy0 = matrix_to_rpy(snap0.w_R_b)                      # [1, 3]
    lam_init = LambdaInit(
        rel_jac_lin=snap0.rel_jac_lin[0], rel_jac_ang=snap0.rel_jac_ang[0],
        jet_axes_world=snap0.jet_axes_world[0],
        jet_arms_world=snap0.jet_arms_world[0], rpy_init=rpy0[0])
    sel = list(joint_sel)
    problem = MPCProblem(
        H=f(assembly.build_hessian(cfg)),
        H_u=f(condensed.build_hu(cfg)),
        Q=f(assembly.state_weight_matrix(cfg)),
        lambda_init=lam_init,
        joint_pos_ref_ctrl=snap0.joint_pos[0, sel],
        com_pos_init=snap0.com_pos[0],
        rpy_init=rpy0[0],
        traj_pos=f(traj_channels["positionCoM"]),
        traj_vel=f(traj_channels["velocityCoM"]),
        traj_rpy=f(traj_channels["RPY"]),
        traj_rpydot=f(traj_channels["RPYDot"]),
        alpha_traj=f(alpha_traj),
        scaling=admm.Scaling(torch.ones(cfg.n_var, dtype=dtype, device=dev),
                             torch.ones(cfg.n_constraints, dtype=dtype,
                                        device=dev),
                             torch.ones((), dtype=dtype, device=dev)),
    )

    # initial window: every column = first trajectory sample
    i32 = dict(dtype=torch.int32, device=dev)
    p0, lin0, rpyc0, ang0 = _window_column(problem, snap0,
                                           torch.zeros(1, **i32))
    n_ref = cfg.n_reference_knots

    def tile(v):
        return v[:, :, None].expand(1, 3, n_ref).clone()

    last = cfg.ratio_small_large - 1
    cond = cfg.qp_solver == "condensed"
    carry = MPCCarry(
        rpy_old=rpy0, n_turns=torch.zeros((1, 3), **i32),
        # both counters start saturated so the configure-time first compute
        # leaves them at 0
        throttle_counter=torch.full((1,), last, **i32),
        ref_counter=torch.full((1,), last, **i32),
        pos_com_ref=tile(p0), lin_mom_ref=tile(lin0), rpy_ref=tile(rpyc0),
        ang_mom_ref=tile(ang0),
        pos_com_ref_now=p0, rpy_ref_now=rpyc0,
        mom_ref_now=torch.cat([lin0, ang0], dim=-1),
        pos_traj_idx=torch.zeros((1,), **i32),
        alpha_traj_idx=torch.zeros((1,), **i32),
        alpha_gravity=problem.alpha_traj[:1].clone(),
        thrust_des=snap0.jet_thrusts.clone(),
        thrust_dot_des=torch.zeros((1, 4), dtype=dtype, device=dev),
        throttle_cmd=initial_throttle,
        joints_pos_ref=snap0.joint_pos.clone(),
        warm_x=torch.zeros((1, condensed.n_inputs(cfg) if cond
                            else cfg.n_var), dtype=dtype, device=dev),
        warm_y=torch.zeros((1, condensed.n_box(cfg) if cond
                            else cfg.n_constraints), dtype=dtype, device=dev),
    )

    # --- the configure-time first compute ---------------------------------
    if not cond:
        g, A, lb, ub, carry, _ = _assemble(cfg, sched, joint_sel, problem,
                                           carry, snap0, est_thrust_dot)
        *_, scaling = admm.ruiz_equilibration(problem.H, g, A, lb, ub,
                                              settings.scaling_iters)
        return problem._replace(scaling=admm.Scaling(
            *(t[0] for t in scaling))), carry
    carry, prep = _tick_prep(cfg, joint_sel, problem, carry, snap0,
                             est_thrust_dot)
    qp0, _, _, _ = condense_from_prep(cfg, sched, joint_sel, problem, carry,
                                      prep)
    scaling, kinv0, rho_vec0, rho_scalar0 = condensed.setup(cfg, qp0,
                                                            settings)
    problem = problem._replace(cond_scaling=condensed.CondensedScaling(
        D=scaling.D[0], c=scaling.c[0]))
    if settings.kinv_carry:
        carry = carry._replace(kinv=kinv0, rho_vec=rho_vec0,
                               rho_scalar=rho_scalar0)
    return problem, carry
