# Frozen copy of tests/golden_oracle.py as of commit 2d24eda7a0d7a9d4be12570fd6e8a3bbe6854107 (its docstring's path to the upstream sources reworded); edit nothing below this line.
"""Independent float64 golden oracle for the multi-rate MPC QP.

A from-scratch NumPy transcription of the reference's QP assembly equations —
deliberately sharing **no code** with ironcub_mpc_tpu (different structure,
different intermediate quantities, float64 throughout) so that a shared sign
or frame error in qp/blocks.py + qp/condensed.py cannot cancel out.

Transcribed equations (file:line refer to the upstream repository's src/):
- three dynamics blocks:   flight-controller/momentum-based-linear-mpc-lib/
  src/variableSamplingMPC/systemDynamicsVSMPC.cpp:79-226 (angular),
  :288-350 (linear), :384-461 (jet)
- multi-rate discretizer:  .../constraintsVSMPC.cpp:45-131
- initial state rows:      .../constraintsVSMPC.cpp:206-247 + IQPUtilsMPC.cpp:71-92
- throttle rows:           .../constraintsVSMPC.cpp:279-374
- tracking cost:           .../costsVSMPC.cpp:74-178,191-263
- regularization costs:    .../costsVSMPC.cpp:369-413,468-486,558-591
- jet polynomial model:    flight-controller/utils/src/JetModel.cpp:10-114
- A_mom / body transform:  flight-controller/utils/src/Robot.cpp:262-266,324-329
"""

from __future__ import annotations

import numpy as np

# ---- state layout (VSconstant.h:6-16) --------------------------------------
COM = slice(0, 3)
LINMOM = slice(3, 6)
RPY = slice(6, 9)
ANGMOM = slice(9, 12)
THRUST = slice(12, 16)
THRUSTDOT = slice(16, 20)
POSERR = slice(20, 23)
RPYERR = slice(23, 26)
NS = 26

# ---- jet model data (JetModel.cpp:13-26; model data, not code) -------------
CF = np.array([-4.64730485e-01, -8.13171858e+00, -6.19539230e+00,
               6.61113140e-01, 1.67673231e+00, -4.83287064e-01,
               8.77996617e+00, -1.01096376e+00, -5.86442286e-01,
               5.19093322e-01, -4.23782666e-01, -1.45705257e+00,
               -7.83052261e-03])
NORM_T_MEAN, NORM_T_STD, NORM_U_MEAN, NORM_U_STD = 108.309, 65.793, 47.333, 31.483


def _f(T, Td):
    return CF[0] + CF[1] * T + CF[2] * Td + CF[3] * T * Td + CF[4] * T**2 + CF[5] * Td**2


def _g(T, Td):
    return CF[6] + CF[7] * T + CF[8] * Td + CF[9] * T * Td + CF[10] * T**2 + CF[11] * Td**2


def _df_dT(T, Td):
    return CF[1] + CF[3] * Td + 2 * CF[4] * T


def _df_dTd(T, Td):
    return CF[2] + CF[3] * T + 2 * CF[5] * Td


def _dg_dT(T, Td):
    return CF[7] + CF[9] * Td + 2 * CF[10] * T


def _dg_dTd(T, Td):
    return CF[8] + CF[9] * T + 2 * CF[11] * Td


def _v(u_std):
    return u_std + CF[12] * u_std**2


def _std_T(T):
    return (T - NORM_T_MEAN) / NORM_T_STD


def _std_Td(Td):
    return Td / NORM_T_STD


def _std_u(u):
    return (u - NORM_U_MEAN) / NORM_U_STD


def _skew(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def _rpy_from_matrix(R):
    """iDynTree asRPY convention: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


def _w_inverse(rpy):
    """Literal transcription of systemDynamicsVSMPC.cpp:140-147."""
    r, p = rpy[0], rpy[1]
    Wi = np.zeros((3, 3))
    Wi[0, 0] = 1.0
    Wi[0, 1] = np.sin(r) * np.tan(p)
    Wi[1, 1] = np.cos(r)
    Wi[2, 1] = np.sin(r) / np.cos(p)
    Wi[0, 2] = np.cos(r) * np.tan(p)
    Wi[1, 2] = -np.sin(r)
    Wi[2, 2] = np.cos(r) / np.cos(p)
    return Wi


def _w_matrix(rpy):
    """Literal transcription of costsVSMPC.cpp:582-590 (m_W)."""
    r, p = rpy[0], rpy[1]
    W = np.zeros((3, 3))
    W[0, 0] = 1.0
    W[1, 1] = np.cos(r)
    W[2, 1] = -np.sin(r)
    W[0, 2] = -np.sin(p)
    W[1, 2] = np.cos(p) * np.sin(r)
    W[2, 2] = np.cos(r) * np.cos(p)
    return W


# ---------------------------------------------------------------------------
# continuous-time linearization (sum of the three blocks)
# ---------------------------------------------------------------------------


def linearize(d: dict) -> tuple:
    """Ac, BJ, BT, c from recorded snapshot primitives.

    ``d`` keys (all float64): w_R_b, base_ang_vel_world, com_pos, total_mass,
    inertia_locked, jet_axes_world [4,3], jet_arms_world [4,3], jet_thrusts,
    rel_jac_lin/rel_jac_ang [4,3,J], jac_jets_lin_joints [4,3,J],
    jac_com_joints [3,J], init_* configure-time copies, joint_sel [n_ctrl],
    alpha_gravity, pos_com_ref_now, rpy_init, thrust_des, thrust_dot_des,
    est_thrust_dot, throttle_cmd, lambda_option, use_jet_dynamic,
    use_estimated_thrust.
    """
    R = d["w_R_b"]
    nJ = d["rel_jac_ang"].shape[2]
    n_ctrl = len(d["joint_sel"])
    Ac = np.zeros((NS, NS))
    BJ = np.zeros((NS, n_ctrl))
    BT = np.zeros((NS, 4))
    c = np.zeros(NS)

    omega_body = R.T @ d["base_ang_vel_world"]
    rpy = _rpy_from_matrix(R)

    # --- A_mom from axes/arms (Robot.cpp:262-266) then body transform
    # (Robot.cpp:324-329: AdjointWrench of (R⁻¹, 0) = blockdiag(Rᵀ, Rᵀ)) ----
    amom_w = np.zeros((6, 4))
    for i in range(4):
        a, r_arm = d["jet_axes_world"][i], d["jet_arms_world"][i]
        amom_w[0:3, i] = a
        amom_w[3:6, i] = _skew(r_arm) @ a
    amom_body = np.zeros((6, 4))
    amom_body[0:3] = R.T @ amom_w[0:3]
    amom_body[3:6] = R.T @ amom_w[3:6]

    # --- angular block (systemDynamicsVSMPC.cpp:79-103) --------------------
    Ac[RPY, ANGMOM] = _w_inverse(rpy) @ np.linalg.inv(d["inertia_locked"])
    Ac[ANGMOM, ANGMOM] -= _skew(omega_body)
    Ac[ANGMOM, THRUST] = amom_body[3:6]
    # λ_ang (systemDynamicsVSMPC.cpp:159-206)
    lam_ang = np.zeros((3, nJ))
    if d["lambda_option"] == "unfiltered":
        for i in range(4):
            a_b = R.T @ d["jet_axes_world"][i]
            r_b = R.T @ d["jet_arms_world"][i]
            # getRelativeJacobianCoM (:208-226): Rᵀ (J_jet,lin − J_com)
            j_rel_com = R.T @ (d["jac_jets_lin_joints"][i] - d["jac_com_joints"])
            lam_ang -= d["jet_thrusts"][i] * (_skew(a_b) @ j_rel_com)
            lam_ang -= d["jet_thrusts"][i] * (
                _skew(r_b) @ _skew(a_b) @ d["rel_jac_ang"][i])
    else:  # constant (:187-199): configure-time jacobians/axes/arms
        for i in range(4):
            a_b = R.T @ d["init_jet_axes_world"][i]
            r_b = R.T @ d["init_jet_arms_world"][i]
            Si = np.hstack([_skew(a_b), _skew(r_b) @ _skew(a_b)])
            Jfull = np.vstack([d["init_rel_jac_lin"][i], d["init_rel_jac_ang"][i]])
            lam_ang -= d["jet_thrusts"][i] * (Si @ Jfull)
    # name-based column selection (:202-205)
    BJ[ANGMOM, :] = lam_ang[:, d["joint_sel"]]
    Ac[RPYERR, RPY] = np.eye(3)
    c[RPYERR] = -d["rpy_init"]

    # --- linear block (systemDynamicsVSMPC.cpp:288-350) --------------------
    Ac[COM, LINMOM] = R / d["total_mass"]
    Ac[LINMOM, LINMOM] -= _skew(omega_body)
    Ac[LINMOM, THRUST] = amom_body[0:3]
    lam_lin = np.zeros((3, nJ))
    if d["lambda_option"] == "unfiltered":
        for i in range(4):
            a_b = R.T @ d["jet_axes_world"][i]
            lam_lin -= d["jet_thrusts"][i] * (_skew(a_b) @ d["rel_jac_ang"][i])
    else:
        for i in range(4):
            a_b = R.T @ d["init_jet_axes_world"][i]
            lam_lin -= d["jet_thrusts"][i] * (_skew(a_b) @ d["init_rel_jac_ang"][i])
    # hard-coded middleCols(3, nCtrl) slice (:348)
    BJ[LINMOM, :] = lam_lin[:, 3:3 + n_ctrl]
    gvec = np.array([0.0, 0.0, -9.81])
    c[LINMOM] = d["alpha_gravity"] * d["total_mass"] * (R.T @ gvec)
    Ac[POSERR, COM] = np.eye(3)
    c[POSERR] = -d["pos_com_ref_now"]

    # --- jet block (systemDynamicsVSMPC.cpp:384-461) ------------------------
    if d["use_jet_dynamic"]:
        Ac[THRUST, THRUSTDOT] = np.eye(4)
        for i in range(4):
            if d["use_estimated_thrust"]:
                T, Td = d["jet_thrusts"][i], d["est_thrust_dot"][i]
            else:
                T, Td = d["thrust_des"][i], d["thrust_dot_des"][i]
            Ts, Tds = _std_T(T), _std_Td(Td)
            us = _std_u(d["throttle_cmd"][i])
            dh_dT = _df_dT(Ts, Tds) + _dg_dT(Ts, Tds) * _v(us)
            dh_dTd = _df_dTd(Ts, Tds) + _dg_dTd(Ts, Tds) * _v(us)
            Ac[16 + i, 12 + i] = dh_dT
            Ac[16 + i, 16 + i] += dh_dTd
            # B linearized at the *desired* thrust state (:414-415)
            Tds_, Tdds_ = _std_T(d["thrust_des"][i]), _std_Td(d["thrust_dot_des"][i])
            BT[16 + i, i] = _g(Tds_, Tdds_) * NORM_T_STD
            c[16 + i] = _f(Ts, Tds) * NORM_T_STD - dh_dT * T - dh_dTd * Td
    else:
        BT[THRUST, :] = np.eye(4)

    return Ac, BJ, BT, c


# ---------------------------------------------------------------------------
# full-space QP assembly
# ---------------------------------------------------------------------------


def warp_dts(n_iter, n_small, dt_small, dt_large):
    """constraintsVSMPC.cpp:45-52,76-84."""
    beta2 = (dt_large - n_small * dt_small) / (n_small * (n_small - 1))
    beta1 = dt_small - beta2
    w = lambda t: beta1 * t + beta2 * t * t
    return np.array([w(i + 1) - w(i) if i < n_small else dt_large
                     for i in range(n_iter)])


def assemble(d: dict, cfg: dict) -> dict:
    """Full H, g, A, lb, ub (reference block/row order) + condensed form.

    ``cfg`` keys: n_iter, n_iter_small, control_horizon, dt_small, dt_large,
    weights (w_com, w_com_err, w_lin, w_rpy, w_rpy_err, w_ang, w_dq [n_ctrl],
    w_throttle, w_throttle0, w_jreg), throttle_min/max.
    """
    ni, ns_small, ch = cfg["n_iter"], cfg["n_iter_small"], cfg["control_horizon"]
    n_ctrl = len(d["joint_sel"])
    nt = 4
    n_tk = ch - ns_small + 1                      # throttle knots
    n_var = NS * (ni + 1) + n_ctrl * ch + nt * n_tk
    jo = NS * (ni + 1)
    to = jo + n_ctrl * ch

    Ac, BJ, BT, cvec = linearize(d)
    dts = warp_dts(ni, ns_small, cfg["dt_small"], cfg["dt_large"])

    # --- dynamics rows (constraintsVSMPC.cpp:76-131) ------------------------
    A_dyn = np.zeros((NS * ni, n_var))
    b_dyn = np.zeros(NS * ni)
    for i in range(ni):
        dt = dts[i]
        r = i * NS
        A_dyn[r:r + NS, i * NS:(i + 1) * NS] = np.eye(NS) + dt * Ac
        A_dyn[r:r + NS, (i + 1) * NS:(i + 2) * NS] = -np.eye(NS)
        jcol = jo + (i if i < ch else ch - 1) * n_ctrl
        A_dyn[r:r + NS, jcol:jcol + n_ctrl] = dt * BJ
        if i < ns_small:
            tcol = to
        elif i < ch:
            tcol = to + (i - (ns_small - 1)) * nt
        else:
            tcol = to + (ch - ns_small) * nt
        A_dyn[r:r + NS, tcol:tcol + nt] = dt * BT
        b_dyn[r:r + NS] = -dt * cvec

    # --- initial-state rows (IQPUtilsMPC.cpp:71-92 + constraintsVSMPC:206-228)
    A_init = np.zeros((NS, n_var))
    A_init[:, :NS] = np.eye(NS)
    x0 = np.zeros(NS)
    x0[COM] = d["com_pos"]
    x0[LINMOM] = d["momentum_body"][:3]
    x0[RPY] = d["rpy_unwrapped"]
    x0[ANGMOM] = d["momentum_body"][3:]
    if d["use_estimated_thrust"]:
        x0[THRUST] = d["jet_thrusts"]
        x0[THRUSTDOT] = d["est_thrust_dot"]
    else:
        x0[THRUST] = d["thrust_des"]
        x0[THRUSTDOT] = d["thrust_dot_des"]
    x0[POSERR] = d["com_pos"] - d["pos_com_ref_now"]
    x0[RPYERR] = d["rpy_unwrapped"] - d["rpy_ref_now"]

    # --- throttle rows (constraintsVSMPC.cpp:279-374) -----------------------
    n_thr_rows = nt * (ni - ns_small + 1)         # declared size (:283)
    A_thr = np.zeros((n_thr_rows, n_var))
    lb_thr = np.zeros(n_thr_rows)
    ub_thr = np.zeros(n_thr_rows)
    v_min = _v(_std_u(cfg["throttle_min"]))
    v_max = _v(_std_u(cfg["throttle_max"]))
    for i in range(n_tk):
        A_thr[i * nt:(i + 1) * nt, to + i * nt:to + (i + 1) * nt] = np.eye(nt)
        if d["pin_first_knot"] and i == 0:
            pin = _v(_std_u(d["throttle_cmd"]))
            lb_thr[0:nt] = pin
            ub_thr[0:nt] = pin
        else:
            lb_thr[i * nt:(i + 1) * nt] = v_min
            ub_thr[i * nt:(i + 1) * nt] = v_max

    # --- optional joint-position rows (constraintsVSMPC.cpp:388-456:
    # per-knot identity on the joint deltas, bounds = remaining range from
    # the current integrated position). Deliberate deviation, mirrored from
    # the library: the reference flips m_firstIteriation *inside* the knot
    # loop (constraintsVSMPC.cpp:440-448) so only knot 0's identity block is
    # ever written — knots 1..ch-1 get bounds but zero matrix rows. We fill
    # every controlHorizon knot (see qp/assembly.build_joint_position_rows
    # docstring for the rationale). ----------------------------------------
    joint_limits = bool(cfg.get("joint_limits", False))
    if joint_limits:
        n_j_rows = n_ctrl * ni
        A_jnt = np.zeros((n_j_rows, n_var))
        lb_jnt = np.zeros(n_j_rows)
        ub_jnt = np.zeros(n_j_rows)
        qmin = np.asarray(cfg["joint_pos_min"], np.float64)
        qmax = np.asarray(cfg["joint_pos_max"], np.float64)
        for i in range(ch):
            r = i * n_ctrl
            A_jnt[r:r + n_ctrl, jo + i * n_ctrl:jo + (i + 1) * n_ctrl] = (
                np.eye(n_ctrl))
            lb_jnt[r:r + n_ctrl] = qmin - d["joint_pos_ctrl"]
            ub_jnt[r:r + n_ctrl] = qmax - d["joint_pos_ctrl"]
        A = np.vstack([A_dyn, A_init, A_thr, A_jnt])
        lb = np.concatenate([b_dyn, x0, lb_thr, lb_jnt])
        ub = np.concatenate([b_dyn, x0, ub_thr, ub_jnt])
    else:
        A = np.vstack([A_dyn, A_init, A_thr])
        lb = np.concatenate([b_dyn, x0, lb_thr])
        ub = np.concatenate([b_dyn, x0, ub_thr])

    # --- Hessian (costsVSMPC.cpp:166-174,375-409,470-477,560-573) -----------
    Q = np.zeros((NS, NS))
    Q[COM, COM] = np.diag(cfg["w_com"])
    Q[LINMOM, LINMOM] = np.diag(cfg["w_lin"])
    Q[RPY, RPY] = np.diag(cfg["w_rpy"])
    Q[ANGMOM, ANGMOM] = np.diag(cfg["w_ang"])
    Q[POSERR, POSERR] = np.diag(cfg["w_com_err"])
    Q[RPYERR, RPYERR] = np.diag(cfg["w_rpy_err"])
    H = np.zeros((n_var, n_var))
    for i in range(1, ni + 1):
        H[i * NS:(i + 1) * NS, i * NS:(i + 1) * NS] += Q
    for i in range(ch):
        blk = slice(jo + i * n_ctrl, jo + (i + 1) * n_ctrl)
        H[blk, blk] += np.diag(cfg["w_dq"]) + cfg["w_jreg"] * np.eye(n_ctrl)
    wt = cfg["w_throttle"] * np.eye(nt)
    for i in range(ch - ns_small):
        a = slice(to + i * nt, to + (i + 1) * nt)
        b = slice(to + (i + 1) * nt, to + (i + 2) * nt)
        H[a, a] += wt
        H[b, b] += wt
        H[a, b] -= wt
        H[b, a] -= wt
    H[to:to + nt, to:to + nt] += cfg["w_throttle0"] * np.eye(nt)

    # --- state reference expansion (costsVSMPC.cpp:191-263) -----------------
    state_ref = np.zeros((NS, ni))
    for i in range(ni):
        col = 0 if i < ns_small else i - ns_small
        state_ref[COM, i] = d["win_pos"][:, col]
        state_ref[LINMOM, i] = d["win_lin"][:, col]
        state_ref[RPY, i] = d["win_rpy"][:, col]
        state_ref[ANGMOM, i] = d["win_ang"][:, col]

    # --- gradient (costsVSMPC.cpp:175-178,479-486,574-591) ------------------
    g = np.zeros(n_var)
    for i in range(1, ni + 1):
        g[i * NS:(i + 1) * NS] = -Q @ state_ref[:, i - 1]
    jreg = cfg["w_jreg"] * (d["joint_pos_ctrl"] - d["joint_pos_ref_ctrl"])
    for i in range(ch):
        g[jo + i * n_ctrl:jo + (i + 1) * n_ctrl] = jreg
    g[to:to + nt] = -cfg["w_throttle0"] * _v(_std_u(d["throttle_cmd"]))

    # --- condensed form by exact elimination through the dynamics ----------
    nU = n_ctrl * ch + nt * n_tk
    F = np.zeros((ni, NS, nU))
    f = np.zeros((ni, NS))
    Fk = np.zeros((NS, nU))
    fk = x0.copy()
    for i in range(ni):
        dt = dts[i]
        Ad = np.eye(NS) + dt * Ac
        Mk = np.zeros((NS, nU))
        jcol = (i if i < ch else ch - 1) * n_ctrl
        Mk[:, jcol:jcol + n_ctrl] += dt * BJ
        if i < ns_small:
            tcol = n_ctrl * ch
        elif i < ch:
            tcol = n_ctrl * ch + (i - (ns_small - 1)) * nt
        else:
            tcol = n_ctrl * ch + (ch - ns_small) * nt
        Mk[:, tcol:tcol + nt] += dt * BT
        Fk = Ad @ Fk + Mk
        fk = Ad @ fk + dt * cvec
        F[i] = Fk
        f[i] = fk
    H_u = (H[jo:, jo:]).copy()
    Hc = H_u.copy()
    qc = np.zeros(nU)
    for i in range(ni):
        Hc += F[i].T @ Q @ F[i]
        qc += F[i].T @ Q @ (f[i] - state_ref[:, i])
    qc[:n_ctrl * ch] += np.tile(jreg, ch)
    qc[n_ctrl * ch:n_ctrl * ch + nt] += -cfg["w_throttle0"] * _v(
        _std_u(d["throttle_cmd"]))
    if d["pin_first_knot"]:
        pin = _v(_std_u(d["throttle_cmd"]))
        lbc0, ubc0 = pin, pin
    else:
        lbc0 = np.full(nt, v_min)
        ubc0 = np.full(nt, v_max)
    lbc = np.concatenate([np.broadcast_to(lbc0, (nt,)),
                          np.full(nt * (n_tk - 1), v_min)])
    ubc = np.concatenate([np.broadcast_to(ubc0, (nt,)),
                          np.full(nt * (n_tk - 1), v_max)])
    if joint_limits:
        # condensed box extends over the joint-delta head too
        lbc = np.concatenate([np.tile(qmin - d["joint_pos_ctrl"], ch), lbc])
        ubc = np.concatenate([np.tile(qmax - d["joint_pos_ctrl"], ch), ubc])

    return dict(H=H, g=g, A=A, lb=lb, ub=ub, Ac=Ac, BJ=BJ, BT=BT, c=cvec,
                x0=x0, state_ref=state_ref, Hc=Hc, qc=qc, lbc=lbc, ubc=ubc,
                F=F, f=f)


# ---------------------------------------------------------------------------
# closed-loop oracle: exact box-QP solve + multi-tick orchestration
# ---------------------------------------------------------------------------


def _destd_throttle(v):
    """Invert v(ū)=ū+c₁₂ū², destandardize, clamp (JetModel.cpp:93-109)."""
    us = (-1.0 + np.sqrt(1.0 + 4.0 * CF[12] * v)) / (2.0 * CF[12])
    return np.clip(us * NORM_U_STD + NORM_U_MEAN, 0.0, 100.0)


def solve_box_qp(H, q, lb, ub, n_free, tol=1e-11, max_pivots=500):
    """Exact minimizer of ½uᵀHu + qᵀu s.t. lb ≤ u[n_free:] ≤ ub.

    Primal-dual active-set in float64 (single worst-violator pivot per
    iteration); deliberately a *different algorithm* from the library's ADMM
    so solver-specific artifacts cannot cancel. Rows with lb==ub are pinned
    equalities, never released. H must be positive definite on the free set.
    """
    n = H.shape[0]
    nb = n - n_free
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    eq = np.abs(ub - lb) <= 1e-12
    active = np.zeros(nb, dtype=int)           # -1 at lb, 0 free, +1 at ub
    active[eq] = -1
    for _ in range(max_pivots):
        fix = active != 0
        idx_fix = np.nonzero(fix)[0] + n_free
        idx_free = np.setdiff1d(np.arange(n), idx_fix)
        u = np.zeros(n)
        u[idx_fix] = np.where(active[fix] == -1, lb[fix], ub[fix])
        rhs = -(q[idx_free] + H[np.ix_(idx_free, idx_fix)] @ u[idx_fix])
        u[idx_free] = np.linalg.solve(H[np.ix_(idx_free, idx_free)], rhs)
        grad = H @ u + q
        bv, gb = u[n_free:], grad[n_free:]
        viol_lo = (active == 0) & (bv < lb - tol)
        viol_hi = (active == 0) & (bv > ub + tol)
        # KKT: fixed at lb needs grad ≥ 0, fixed at ub needs grad ≤ 0
        rel_lo = (active == -1) & ~eq & (gb < -tol)
        rel_hi = (active == +1) & ~eq & (gb > tol)
        score = np.zeros(nb)
        score[viol_lo] = lb[viol_lo] - bv[viol_lo]
        score[viol_hi] = bv[viol_hi] - ub[viol_hi]
        score[rel_lo] = -gb[rel_lo]
        score[rel_hi] = gb[rel_hi]
        if score.max(initial=0.0) <= 0.0:
            return u
        k = int(np.argmax(score))
        active[k] = -1 if viol_lo[k] else (+1 if viol_hi[k] else 0)
    raise RuntimeError("solve_box_qp: active set did not converge")


class OracleMPC:
    """Independent float64 closed-loop MPC: the full multi-tick orchestration
    (reference-window shifts, multi-rate counters, RPY unwrap, alphaGravity
    cursor, command integration) in plain NumPy, solving each tick's
    condensed QP *exactly* with an active-set method.

    Mirrors IMPCProblem::configure/update/solve + VariableSamplingMPC::
    solveMPC sequencing (IMPCProblem.cpp:150-298, costsVSMPC.cpp:121-165,
    constraintsVSMPC.cpp:206-247,338-374, variableSamplingMPC.cpp:88-112)
    without sharing any code with ironcub_mpc_tpu — the oracle for the
    BASELINE command-sequence-fidelity north star.
    """

    def __init__(self, ocfg, sd0, joint_sel, traj, alpha_traj,
                 initial_throttle, lambda_option="unfiltered",
                 use_jet_dynamic=True, use_estimated_thrust=True,
                 ratio=None):
        self.ocfg = dict(ocfg)
        self.lambda_option = lambda_option
        self.use_jet_dynamic = use_jet_dynamic
        self.use_estimated_thrust = use_estimated_thrust
        self.sel = np.asarray(joint_sel, np.int64)
        self.ratio = ratio if ratio is not None else int(
            round(ocfg["dt_large"] / ocfg["dt_small"]))
        ni, nsm = ocfg["n_iter"], ocfg["n_iter_small"]
        self.n_ref = ni - nsm + 1
        self.traj = {k: np.asarray(v, np.float64) for k, v in traj.items()}
        self.alpha_traj = np.asarray(alpha_traj, np.float64)

        # configure-time constants (mpc.configure / LambdaInit)
        self.init = dict(
            init_rel_jac_lin=sd0["rel_jac_lin"],
            init_rel_jac_ang=sd0["rel_jac_ang"],
            init_jet_axes_world=sd0["jet_axes_world"],
            init_jet_arms_world=sd0["jet_arms_world"],
        )
        rpy0 = _rpy_from_matrix(sd0["w_R_b"])
        self.rpy_init = rpy0
        self.com_pos_init = sd0["com_pos"].copy()
        self.joint_pos_ref_ctrl = sd0["joint_pos"][self.sel].copy()

        # carry (MPCCarry equivalent), counters saturated pre-configure
        self.rpy_old = rpy0.copy()
        self.n_turns = np.zeros(3)
        self.ref_counter = self.ratio - 1
        self.throttle_counter = self.ratio - 1
        p0, l0, r0, a0 = self._window_column(sd0, 0)
        self.win_pos = np.tile(p0[:, None], (1, self.n_ref))
        self.win_lin = np.tile(l0[:, None], (1, self.n_ref))
        self.win_rpy = np.tile(r0[:, None], (1, self.n_ref))
        self.win_ang = np.tile(a0[:, None], (1, self.n_ref))
        self.pos_ref_now, self.rpy_ref_now = p0.copy(), r0.copy()
        self.pos_traj_idx = 0
        self.alpha_idx = 0
        self.thrust_des = sd0["jet_thrusts"].copy()
        self.thrust_dot_des = np.zeros(4)
        self.throttle_cmd = np.asarray(initial_throttle, np.float64).copy()
        self.joints_pos_ref = sd0["joint_pos"].copy()

        # replicate configure's first compute (advances window + alpha once)
        self._prep(sd0, np.zeros(4))

    # -- reference window (costsVSMPC.cpp:103-165,266-286) ------------------
    def _window_column(self, sd, idx):
        i = min(max(idx, 0), self.traj["positionCoM"].shape[0] - 1)
        R, m = sd["w_R_b"], sd["total_mass"]
        p = self.com_pos_init + self.traj["positionCoM"][i]
        lin = R.T @ (m * self.traj["velocityCoM"][i])
        rpy_col = self.rpy_init + self.traj["RPY"][i]
        W = _w_matrix(_rpy_from_matrix(R))
        ang = sd["inertia_locked"] @ (W @ self.traj["RPYDot"][i])
        return p, lin, rpy_col, ang

    def _prep(self, sd, est_thrust_dot):
        """One IMPCProblem::update — returns the assembly dict (or None when
        called from configure, where the QP itself is discarded)."""
        # reference shift
        if self.ref_counter == self.ratio - 1:
            idx_next = min(self.pos_traj_idx + 1,
                           self.traj["positionCoM"].shape[0] - 1)
            p, lin, rpy_col, ang = self._window_column(sd, idx_next)
            shift = lambda w, c: np.concatenate([w[:, 1:], c[:, None]], 1)
            self.win_pos = shift(self.win_pos, p)
            self.win_lin = shift(self.win_lin, lin)
            self.win_rpy = shift(self.win_rpy, rpy_col)
            self.win_ang = shift(self.win_ang, ang)
            self.pos_ref_now = self.win_pos[:, 0].copy()
            self.rpy_ref_now = self.win_rpy[:, 0].copy()
            self.pos_traj_idx = idx_next
            self.ref_counter = 0
        else:
            self.ref_counter += 1

        # alphaGravity read-then-advance
        alpha = self.alpha_traj[self.alpha_idx]
        self.alpha_idx = min(self.alpha_idx + 1, len(self.alpha_traj) - 1)

        # RPY unwrap (constraintsVSMPC.cpp:232-247)
        rpy_raw = _rpy_from_matrix(sd["w_R_b"])
        diff = rpy_raw - self.rpy_old
        self.n_turns = self.n_turns - (diff > np.pi) + (diff < -np.pi)
        rpy_unwrapped = rpy_raw + 2.0 * np.pi * self.n_turns
        self.rpy_old = rpy_raw

        # throttle pin (constraintsVSMPC.cpp:338-374)
        pin = self.throttle_counter != self.ratio - 1
        self.throttle_counter = (0 if self.throttle_counter == self.ratio - 1
                                 else self.throttle_counter + 1)

        d = dict(sd)
        d.update(self.init)
        d.update(
            rpy_init=self.rpy_init,
            joint_pos_ref_ctrl=self.joint_pos_ref_ctrl,
            joint_sel=self.sel,
            win_pos=self.win_pos, win_lin=self.win_lin,
            win_rpy=self.win_rpy, win_ang=self.win_ang,
            pos_com_ref_now=self.pos_ref_now, rpy_ref_now=self.rpy_ref_now,
            alpha_gravity=alpha, rpy_unwrapped=rpy_unwrapped,
            thrust_des=self.thrust_des, thrust_dot_des=self.thrust_dot_des,
            throttle_cmd=self.throttle_cmd,
            joint_pos_ctrl=self.joints_pos_ref[self.sel],
            est_thrust_dot=np.asarray(est_thrust_dot, np.float64),
            pin_first_knot=bool(pin),
            lambda_option=self.lambda_option,
            use_jet_dynamic=self.use_jet_dynamic,
            use_estimated_thrust=self.use_estimated_thrust,
        )
        return d

    def tick(self, sd, est_thrust_dot):
        """One 200 Hz tick → dict of commands (variableSamplingMPC.cpp:88-151)."""
        d = self._prep(sd, est_thrust_dot)
        out = assemble(d, self.ocfg)
        n_ctrl = len(self.sel)
        ch = self.ocfg["control_horizon"]
        n_free = 0 if self.ocfg.get("joint_limits", False) else n_ctrl * ch
        u = solve_box_qp(out["Hc"], out["qc"], out["lbc"], out["ubc"],
                         n_free=n_free)
        states = out["F"] @ u + out["f"]        # [n_iter, 26]
        self.joints_pos_ref = self.joints_pos_ref.copy()
        self.joints_pos_ref[self.sel] += u[:n_ctrl]
        v0 = u[n_ctrl * ch: n_ctrl * ch + 4]
        self.throttle_cmd = _destd_throttle(v0)
        self.thrust_des = states[0, THRUST].copy()
        self.thrust_dot_des = states[0, THRUSTDOT].copy()
        return dict(
            joints_pos_ref=self.joints_pos_ref.copy(),
            throttle=self.throttle_cmd.copy(),
            thrust_des=self.thrust_des.copy(),
            thrust_dot_des=self.thrust_dot_des.copy(),
            final_state=states[-1].copy(),
        )
