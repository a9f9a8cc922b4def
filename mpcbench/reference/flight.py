# Frozen copy of tests/flight_oracle.py (the benchmark's reference of the flight cell); edit nothing below this line.
"""Plain float64 reference of the paper's simulated flight: the 1 kHz plant
with its LSTM jets and thrust EKF, the snapshot the MPC reads, and the
closed-loop tick around ``golden_oracle``'s exact controller step.

Plain PyTorch in float64 on the CPU (TF32 switched off wherever a product
could reach it), one robot, no batching, no kernels, no caches. It imports
neither JAX nor ``ironcub_mpc_tpu_torch``, and reads everything it uses
itself: the configuration file (``mpcbench/configs/mk3_flight.json``), the
URDF it names, the LSTM weights, the mission trajectories, and the states
``tools/make_flight_starts.py`` recorded. What it writes out from the
equations, and where it departs from the published description
(upstream ``ami-iit/paper_gorbani_2025_humanoids_multi-rate-mpc-ironcub``):

- **The model.** Its own URDF parser keeps the tree as authored (rooted at
  ``root_link``) and every link whole; joints not in the configuration's
  axes list and fixed joints hold at zero. The floating base is ``chest``:
  forward kinematics runs from the URDF's root at the identity, and the
  root's world pose follows from the chest's (``T_root = T_chest ·
  T_chest^-1|root``). That is the re-rooting, done in this file's own way:
  iDynTree re-roots the tree itself.
- **Jacobians.** The generalised velocity is iDynTree's MIXED one, ν =
  [v of the chest origin (world); ω (world); q̇]. A joint on the path from
  the chest to a link turns it about its world axis a_j through its origin
  o_j, with sign +1 where the path runs from the URDF parent to the child
  and -1 where it runs back: a point p moves at v_b + ω_b × (p − p_b) +
  Σ ±q̇_j a_j × (p − o_j), the link turns at ω_b + Σ ±q̇_j a_j.
- **Dynamics.** M(q) = Σ_links m Jvᵀ Jv + Jωᵀ I Jω (Jv of the link's
  CoM); the bias forces by Newton-Euler on each link, h = Σ Jvᵀ m (a₀ −
  g) + Jωᵀ (I α₀ + ω × I ω), with a₀ and α₀ the accelerations at ν̇ = 0
  written out from the path (each axis turns with the link that carries
  it). The source's plant is MuJoCo; the port's own plant, which this
  checks, is a penalty-contact rigid body, and so is this:
- **Contacts.** Four corners a sole (±half length, ±half width in the sole
  frame); below the ground a spring-damper normal force, clamped at zero,
  and smooth Coulomb friction −μ f_z v_t / (|v_t| + v_ref).
- **Actuation.** Joint PD at the joints' targets, its damping implicit:
  (M + dt·D) ν̇ = τ − D ν − h with D zero on the base rows; each jet's
  thrust along its frame's −z at its origin; the pass's wind a
  world-frame force at the chest origin; semi-implicit Euler (ν, then
  position, rotation by the exponential of ω dt, and joints).
- **Jets.** The LSTM(2→80)+FC(80→1) cell from a zero state a step
  (upstream's ``nn_jet_model.py`` feeds one normalised (T, u) sample a
  step and carries no state, so only the input, cell and output gates
  act), then T integrates Ṫ by explicit Euler. The EKF over (T, Ṫ) a jet
  predicts with the 13-coefficient polynomial jet model of
  ``golden_oracle`` stepped semi-implicitly (Ṫ first), takes the
  Jacobian of that step at the *predicted* state (upstream's
  ``jet_kalman_filter.py`` calls A after x = f(x, u); kept), here
  differentiated by hand where upstream uses CasADi, and corrects with
  the LSTM's (T, Ṫ) as the measurement (H = I).
- **The snapshot**: every ``RobotSnapshot`` field ``golden_oracle``'s
  ``OracleMPC`` reads (base rotation and angular velocity, CoM, mass,
  body-frame centroidal momentum, the locked inertia at the CoM in the body
  frame, the jets' world axes and arms from the CoM, their thrusts, the
  jets' and the CoM's joint Jacobian columns).
- **The controller** is ``golden_oracle.OracleMPC``: its update of the
  reference windows, counters and cursors, and an exact active-set solve
  of each tick's box QP. Its state at a recorded start is the program's
  recorded controller carry; its problem is configured from its own
  snapshot of the recorded settled state, as the program's is.

Uses: :class:`Flight` for one robot; :func:`step_pass` follows a pass of
the program tick by tick (each tick from the program's plant state and the
program's commands of the tick before), :func:`chain_pass` flies the
reference's own closed loop from a recorded start. Both take and return
NumPy arrays, so a process pool can run them.
"""

from __future__ import annotations

import json
import math
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

try:  # the benchmark's frozen copy sits beside its own oracle
    from . import golden_oracle as oracle
except ImportError:
    import golden_oracle as oracle

F64 = torch.float64
PLANT_FIELDS = ("base_R", "base_p", "base_v", "q", "qd", "thrust_nn",
                "ekf_x", "ekf_P", "throttle", "q_des")
COMMANDS = ("joints_pos_ref", "throttle", "thrust_des", "thrust_dot_des")
CHANNELS = ("positionCoM", "velocityCoM", "RPY", "RPYDot")


def _pin_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


def _skew(v):
    z = torch.zeros((), dtype=F64)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _rot_rpy(r, p, y):
    """URDF's fixed-axis roll-pitch-yaw: Rz(y) Ry(p) Rx(r)."""
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p),
                              math.sin(p), math.cos(y), math.sin(y))
    return _t([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
               [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
               [-sp, cp * sr, cp * cr]])


def _rodrigues(axis, angle):
    """Rotation by ``angle`` about the unit ``axis``."""
    K = _skew(axis)
    return (torch.eye(3, dtype=F64) + torch.sin(angle) * K
            + (1.0 - torch.cos(angle)) * (K @ K))


def _exp(w):
    """exp of the skew matrix of the rotation vector ``w``."""
    th = torch.linalg.vector_norm(w)
    if float(th) < 1e-15:
        return torch.eye(3, dtype=F64) + _skew(w)
    return _rodrigues(w / th, th)


def _origin(elem):
    o = elem.find("origin") if elem is not None else None
    xyz = [0.0, 0.0, 0.0] if o is None or not o.get("xyz") else \
        [float(v) for v in o.get("xyz").split()]
    rpy = [0.0, 0.0, 0.0] if o is None or not o.get("rpy") else \
        [float(v) for v in o.get("rpy").split()]
    return _rot_rpy(*rpy), _t(xyz)


class Robot:
    """The URDF's tree as authored, read by this file's own parser: links
    parents first, each with its mass, CoM and inertia about the CoM in its
    frame, the joint that hangs it from its parent, and the signed path of
    moving joints from the floating base to it."""

    def __init__(self, urdf, axes, base):
        root = ET.parse(urdf).getroot()
        links = {}
        for le in root.findall("link"):
            inr = le.find("inertial")
            if inr is None:
                links[le.get("name")] = (0.0, _t([0, 0, 0]),
                                         torch.zeros((3, 3), dtype=F64))
                continue
            R, p = _origin(inr)
            i = inr.find("inertia")
            g = {k: float(i.get(k, 0.0)) for k in
                 ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")}
            I = _t([[g["ixx"], g["ixy"], g["ixz"]],
                    [g["ixy"], g["iyy"], g["iyz"]],
                    [g["ixz"], g["iyz"], g["izz"]]])
            links[le.get("name")] = (float(inr.find("mass").get("value")),
                                     p, R @ I @ R.T)
        parent_joint = {}
        for je in root.findall("joint"):
            R, p = _origin(je)
            ax = je.find("axis")
            axis = _t([float(v) for v in ax.get("xyz").split()]
                      if ax is not None else [1.0, 0.0, 0.0])
            name = je.get("name")
            moving = je.get("type") in ("revolute", "continuous") \
                and name in axes
            parent_joint[je.find("child").get("link")] = dict(
                name=name, parent=je.find("parent").get("link"), R=R, p=p,
                axis=axis, dof=list(axes).index(name) if moving else -1)
        (top,) = [n for n in links if n not in parent_joint]
        order, frontier = [], [top]
        while frontier:
            n = frontier.pop(0)
            order.append(n)
            frontier += [c for c, j in parent_joint.items()
                         if j["parent"] == n]
        self.names = order
        self.index = {n: i for i, n in enumerate(order)}
        self.joint = [parent_joint.get(n) for n in order]
        self.parent = [-1 if j is None else self.index[j["parent"]]
                       for j in self.joint]
        self.mass = _t([links[n][0] for n in order])
        self.com = torch.stack([links[n][1] for n in order])
        self.inertia = torch.stack([links[n][2] for n in order])
        self.n = len(axes)
        self.base = self.index[base]
        # the joint each DOF moves (the index of its child link)
        self.dof_link = [0] * self.n
        for i, j in enumerate(self.joint):
            if j is not None and j["dof"] >= 0:
                self.dof_link[j["dof"]] = i
        # sign[k, d]: +1 where the path from the base to link k crosses DOF
        # d from its URDF parent to its child, -1 where it crosses it back
        sign = torch.zeros((len(order), self.n), dtype=F64)
        up = self._ancestors(self.base)
        for k in range(len(order)):
            down = self._ancestors(k)
            common = [a for a in up if a in down]
            lca = common[0]
            for a in up[:up.index(lca)]:     # base up to the common link
                d = self.joint[a]["dof"]
                if d >= 0:
                    sign[k, d] -= 1.0
            for a in down[:down.index(lca)]:  # common link down to k
                d = self.joint[a]["dof"]
                if d >= 0:
                    sign[k, d] += 1.0
        self.sign = sign
        self.total_mass = float(self.mass.sum())

    def _ancestors(self, k):
        """k, its parent, ..., the URDF's root."""
        out = [k]
        while self.parent[out[-1]] >= 0:
            out.append(self.parent[out[-1]])
        return out


class Kin(NamedTuple):
    R: torch.Tensor      # [L, 3, 3] link rotations, world
    p: torch.Tensor      # [L, 3] link origins, world
    axis: torch.Tensor   # [n, 3] DOF axes, world
    origin: torch.Tensor  # [n, 3] DOF origins (on the axis), world
    c: torch.Tensor      # [L, 3] link CoMs, world
    I: torch.Tensor      # [L, 3, 3] inertias about the CoMs, world
    p_b: torch.Tensor    # [3] the floating base's origin


def kinematics(robot: Robot, R_b, p_b, q) -> Kin:
    """Every link's world pose with the floating base at (R_b, p_b)."""
    L = len(robot.names)
    Rr, pr = [None] * L, [None] * L
    Rr[0], pr[0] = torch.eye(3, dtype=F64), torch.zeros(3, dtype=F64)
    for i in range(1, L):
        j, a = robot.joint[i], robot.parent[i]
        R = Rr[a] @ j["R"]
        if j["dof"] >= 0:
            R = R @ _rodrigues(j["axis"], q[j["dof"]])
        Rr[i], pr[i] = R, pr[a] + Rr[a] @ j["p"]
    # the root's world pose from the base's: T_root = T_base · T_base|root⁻¹
    Rbr, pbr = Rr[robot.base], pr[robot.base]
    R0 = R_b @ Rbr.T
    p0 = p_b - R0 @ pbr
    R = torch.stack([R0 @ r for r in Rr])
    p = torch.stack([p0 + R0 @ v for v in pr])
    axis = torch.stack([R[robot.dof_link[d]] @ robot.joint[
        robot.dof_link[d]]["axis"] for d in range(robot.n)])
    origin = p[robot.dof_link]
    c = p + (R @ robot.com[..., None])[..., 0]
    I = R @ robot.inertia @ R.transpose(1, 2)
    return Kin(R, p, axis, origin, c, I, p_b)


def point_jacobian(robot: Robot, kin: Kin, links, points):
    """[K, 3, 6+n] velocity maps of ``points`` [K, 3] fixed to ``links``."""
    K = points.shape[0]
    sign = robot.sign[links]                              # [K, n]
    base = torch.cat([torch.eye(3, dtype=F64).expand(K, 3, 3),
                      -torch.stack([_skew(r) for r in points - kin.p_b])],
                     dim=2)
    cols = torch.linalg.cross(kin.axis[None].expand(K, -1, -1),
                              points[:, None, :] - kin.origin[None])
    return torch.cat([base, (sign[..., None] * cols).transpose(1, 2)],
                     dim=2)


def _angular(robot: Robot, kin: Kin, links):
    """[K, 3, 6+n] angular-velocity maps of ``links``."""
    K = len(links)
    base = torch.cat([torch.zeros((K, 3, 3), dtype=F64),
                      torch.eye(3, dtype=F64).expand(K, 3, 3)], dim=2)
    cols = robot.sign[links][:, None, :] * kin.axis.T[None]
    return torch.cat([base, cols], dim=2)


class Dyn(NamedTuple):
    M: torch.Tensor       # [6+n, 6+n]
    h: torch.Tensor       # [6+n] bias forces C(q, ν) ν + G(q)
    Jc: torch.Tensor      # [L, 3, 6+n] link CoM velocity maps
    Jw: torch.Tensor      # [L, 3, 6+n] link angular-velocity maps


def dynamics(robot: Robot, kin: Kin, nu, gravity) -> Dyn:
    L = len(robot.names)
    links = list(range(L))
    Jc = point_jacobian(robot, kin, links, kin.c)
    Jw = _angular(robot, kin, links)
    m = robot.mass
    M = (torch.einsum("l,lai,laj->ij", m, Jc, Jc)
         + torch.einsum("lai,lab,lbj->ij", Jw, kin.I, Jw))
    v_b, w_b, qd = nu[0:3], nu[3:6], nu[6:]
    vc = Jc @ nu                                          # [L, 3]
    w = Jw @ nu                                           # [L, 3]
    # each DOF's axis turns with its child link; its origin moves with it
    w_dof = w[robot.dof_link]
    axis_dot = torch.linalg.cross(w_dof, kin.axis)        # [n, 3]
    J_o = point_jacobian(robot, kin, robot.dof_link, kin.origin)
    v_o = J_o @ nu                                        # [n, 3]
    sq = robot.sign * qd[None]                            # [L, n]
    alpha0 = sq @ axis_dot                                # [L, 3]
    r = kin.c[:, None, :] - kin.origin[None]              # [L, n, 3]
    rel = (vc[:, None, :] - v_o[None])                    # [L, n, 3]
    terms = (torch.linalg.cross(axis_dot[None].expand_as(r), r)
             + torch.linalg.cross(kin.axis[None].expand_as(rel), rel))
    a0 = (torch.linalg.cross(w_b.expand(L, 3), vc - v_b)
          + (sq[..., None] * terms).sum(dim=1))
    g = _t(gravity)
    Iw = (kin.I @ w[..., None])[..., 0]
    f_lin = m[:, None] * (a0 - g)
    f_ang = (kin.I @ alpha0[..., None])[..., 0] + torch.linalg.cross(w, Iw)
    h = (torch.einsum("lai,la->i", Jc, f_lin)
         + torch.einsum("lai,la->i", Jw, f_ang))
    return Dyn(M, h, Jc, Jw)


class LSTMJets:
    """The learned jet model: one zero-state LSTM(2→80) cell and FC(80→1)
    a step, on normalised thrust and throttle, then Euler on T."""

    def __init__(self, path):
        z = np.load(path)
        self.w_ih = _t(z["w_ih"])
        self.b = _t(z["b_ih"]) + _t(z["b_hh"])
        self.fc_w, self.fc_b = _t(z["fc_w"]), _t(z["fc_b"])
        self.H = self.w_ih.shape[0] // 4
        self.norm = {k: float(z[k]) for k in
                     ("thrust_mean", "thrust_std", "throttle_mean",
                      "throttle_std")}

    def step(self, T, u, dt):
        """(T at the next step, Ṫ) [N, N/s] of jets at thrust ``T`` under
        throttle ``u``."""
        n = self.norm
        x = torch.stack([(T - n["thrust_mean"]) / n["thrust_std"],
                         (u - n["throttle_mean"]) / n["throttle_std"]], -1)
        H = self.H
        gates = x @ self.w_ih.T + self.b                   # [jets, 4H]
        i = torch.sigmoid(gates[:, 0:H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        h = o * torch.tanh(i * g)                          # c = f·0 + i·g
        td_n = (h @ self.fc_w.T + self.fc_b)[:, 0]
        t_next_n = x[:, 0] + td_n * dt
        return (t_next_n * n["thrust_std"] + n["thrust_mean"],
                td_n * n["thrust_std"])


def jet_step(T, Td, u, dt):
    """The polynomial jet model a step, semi-implicit: Ṫ first."""
    t, td, us = oracle._std_T(T), oracle._std_Td(Td), oracle._std_u(u)
    tdd = (oracle._f(t, td) + oracle._g(t, td) * oracle._v(us)) \
        * oracle.NORM_T_STD
    td_new = Td + tdd * dt
    return T + td_new * dt, td_new


def jet_step_jacobian(T, Td, u, dt):
    """∂(T', Ṫ')/∂(T, Ṫ) of :func:`jet_step` [jets, 2, 2]: with h = T̈,
    Ṫ' = Ṫ + h dt and T' = T + Ṫ' dt."""
    t, td, us = oracle._std_T(T), oracle._std_Td(Td), oracle._std_u(u)
    v = oracle._v(us)
    h_T = oracle._df_dT(t, td) + oracle._dg_dT(t, td) * v
    h_Td = oracle._df_dTd(t, td) + oracle._dg_dTd(t, td) * v
    return torch.stack([
        torch.stack([1.0 + h_T * dt * dt, dt + h_Td * dt * dt], -1),
        torch.stack([h_T * dt, 1.0 + h_Td * dt], -1)], -2)


def ekf_update(x, P, u, z, dt, R, Q):
    """One predict + correct of each jet's (T, Ṫ) filter: x [jets, 2],
    P [jets, 2, 2], the LSTM's measurement z [jets, 2]."""
    Tp, Tdp = jet_step(x[:, 0], x[:, 1], u, dt)
    xp = torch.stack([Tp, Tdp], -1)
    A = jet_step_jacobian(Tp, Tdp, u, dt)     # at the predicted state
    Pp = A @ P @ A.transpose(1, 2) + Q
    K = Pp @ torch.linalg.inv(Pp + R)
    x_new = xp + (K @ (z - xp)[..., None])[..., 0]
    P_new = (torch.eye(2, dtype=F64) - K) @ Pp
    return x_new, P_new


def upsample(values: np.ndarray, ratio: int) -> np.ndarray:
    """Linear interpolation at ``ratio`` samples a source interval, the last
    source sample dropped (the mission's alphaGravity from 10 Hz to the
    MPC's rate)."""
    if ratio <= 1:
        return values
    frac = np.arange(ratio) / ratio
    a, b = values[:-1], values[1:]
    return (a[:, None] + (b - a)[:, None] * frac[None, :, None]).reshape(
        -1, values.shape[1])


def oracle_settings(config: dict) -> dict:
    """``OracleMPC``'s configuration dict from a configuration file."""
    m = config["mpc"]

    def arr(k):
        return np.asarray(m[k], np.float64)

    return dict(
        n_iter=m["n_iter"], n_iter_small=m["n_iter_small"],
        control_horizon=m["control_horizon"],
        dt_small=m["period_mpc_small_steps"],
        dt_large=m["period_mpc_large_steps"],
        w_com=arr("weight_com_pos"), w_com_err=arr("weight_com_pos_error"),
        w_lin=arr("weight_lin_mom"), w_rpy=arr("weight_rpy"),
        w_rpy_err=arr("weight_rpy_error"), w_ang=arr("weight_ang_mom"),
        w_dq=arr("weight_delta_joint"),
        w_throttle=float(m["weight_throttle"]),
        w_throttle0=float(m["weight_initial_throttle"]),
        w_jreg=float(m["weight_regularization_joint_pos"]),
        throttle_min=float(m["throttle_min"]),
        throttle_max=float(m["throttle_max"]),
        joint_limits=bool(m["use_joint_position_constraint"]),
        joint_pos_min=np.deg2rad(arr("joint_pos_min_deg")),
        joint_pos_max=np.deg2rad(arr("joint_pos_max_deg")),
    )


def plant_state(flat: dict, prefix: str) -> dict:
    """One lane of a recorded plant state (``<prefix>.<field>`` arrays, lane
    first) as this file's state dict of float64 tensors."""
    def f(name):
        return _t(np.asarray(flat[f"{prefix}.{name}"])[0])
    return dict(base_R=f("base_R"), base_p=f("base_p"), base_v=f("base_v"),
                q=f("q"), qd=f("qd"), thrust_nn=f("thrust_nn"),
                ekf_x=f("ekf.x"), ekf_P=f("ekf.P"), throttle=f("throttle"),
                q_des=f("q_des"))


class Flight:
    """The flight of one robot under a configuration file: the plant, the
    snapshot, and the controller configured from the recorded settled
    state ``start`` (a ``flight_start.npz``)."""

    def __init__(self, config_path, start):
        _pin_precision()
        config_path = Path(config_path)
        root = config_path.parents[2]   # mpcbench/configs/<name>.json
        self.config = config = json.loads(config_path.read_text())
        rb, sim, pl = config["robot"], config["sim"], config["plant"]
        self.robot = Robot(root / config["model"]["urdf"], rb["axes_list"],
                           rb["base_frame"])
        self.lstm = LSTMJets(root / config["model"]["lstm_weights"])
        self.dt = float(sim["timestep"])
        if sim["simulate_noise"] or not sim["use_nn_jet_dynamics"]:
            raise ValueError("the reference flies the LSTM jets without "
                             "sensor noise")
        self.gravity = rb["gravity"]
        self.plant_params = pl
        ek = config["ekf"]
        self.R_ekf = ek["r"] * torch.eye(2, dtype=F64)
        self.Q_ekf = ek["q"] * torch.eye(2, dtype=F64)
        self.jets = [self.robot.index[n] for n in rb["jets_list"]]
        self.soles = [self.robot.index[n] for n in rb["sole_frames"]]
        self.jet_axis = _t(rb["jet_axis_local"])
        hx, hy = pl["foot_half_x"], pl["foot_half_y"]
        self.corners = _t([[hx, hy, 0], [hx, -hy, 0], [-hx, hy, 0],
                           [-hx, -hy, 0]])
        n = self.robot.n
        self.D = torch.cat([torch.zeros(6, dtype=F64),
                            torch.full((n,), float(pl["kd"]), dtype=F64)])
        m = config["mpc"]
        self.substeps = round(m["period_mpc"] / self.dt)
        self.sel = np.asarray([list(rb["axes_list"]).index(j)
                               for j in m["controlled_joints"]], np.int64)
        traj = np.load(root / m["position_trajectory"])
        alpha = np.load(root / m["alpha_gravity_trajectory"])
        ratio = int((1.0 / m["period_mpc"])
                    / float(np.asarray(alpha["fps"]).reshape(-1)[0]))
        self.traj = {k: np.asarray(traj[k], np.float64) for k in CHANNELS}
        self.alpha = upsample(np.asarray(alpha["alphaGravity"], np.float64),
                              ratio)[:, 0]
        self.start = plant_state(start, "plant")

    # -- the snapshot ----------------------------------------------------
    def snapshot(self, st: dict) -> dict:
        """Every snapshot field ``OracleMPC`` reads, as float64 NumPy."""
        rb = self.robot
        kin = kinematics(rb, st["base_R"], st["base_p"], st["q"])
        nu = torch.cat([st["base_v"], st["qd"]])
        L = len(rb.names)
        Jc = point_jacobian(rb, kin, list(range(L)), kin.c)
        Jw = _angular(rb, kin, list(range(L)))
        m = rb.mass
        com = (m[:, None] * kin.c).sum(0) / m.sum()
        vc, w = Jc @ nu, Jw @ nu
        d = kin.c - com
        lin = (m[:, None] * vc).sum(0)
        ang = (torch.linalg.cross(d, m[:, None] * vc)
               + (kin.I @ w[..., None])[..., 0]).sum(0)
        Rb = st["base_R"]
        eye = torch.eye(3, dtype=F64)
        I_G = (kin.I + m[:, None, None] * ((d * d).sum(-1)[:, None, None]
                                           * eye - d[:, :, None]
                                           * d[:, None, :])).sum(0)
        J_com = (m[:, None, None] * Jc).sum(0) / m.sum()
        R_j, p_j = kin.R[self.jets], kin.p[self.jets]
        Jj = point_jacobian(rb, kin, self.jets, p_j)
        Jjw = _angular(rb, kin, self.jets)

        def out(t):
            return t.detach().numpy().astype(np.float64)

        return dict(
            w_R_b=out(Rb), base_ang_vel_world=out(st["base_v"][3:6]),
            com_pos=out(com), total_mass=np.float64(rb.total_mass),
            momentum_body=out(torch.cat([Rb.T @ lin, Rb.T @ ang])),
            inertia_locked=out(Rb.T @ I_G @ Rb),
            jet_axes_world=out(R_j @ self.jet_axis),
            jet_arms_world=out(p_j - com),
            jet_thrusts=out(st["ekf_x"][:, 0]),
            rel_jac_lin=out(Jj[:, :, 6:]), rel_jac_ang=out(Jjw[:, :, 6:]),
            jac_jets_lin_joints=out(Jj[:, :, 6:]),
            jac_com_joints=out(J_com[:, 6:]),
            joint_pos=out(st["q"]))

    # -- the plant -------------------------------------------------------
    def _contact(self, kin: Kin, nu):
        """(generalised force, [soles, 4, 3] corner forces) of the sole
        corners' penalty contacts."""
        pl = self.plant_params
        links = [s for s in self.soles for _ in range(4)]
        pts = torch.cat([kin.p[s] + (kin.R[s] @ self.corners.T).T
                         for s in self.soles])
        J = point_jacobian(self.robot, kin, links, pts)
        v = J @ nu
        pen = -pts[:, 2]
        fz = torch.clamp(pl["contact_kp"] * pen - pl["contact_kd"] * v[:, 2],
                         min=0.0)
        fz = torch.where(pen > 0, fz, torch.zeros_like(fz))
        vt = v[:, 0:2]
        ft = -pl["friction_mu"] * fz[:, None] * vt / (
            torch.linalg.vector_norm(vt, dim=1, keepdim=True)
            + pl["friction_vel"])
        f = torch.cat([ft, fz[:, None]], dim=1)
        return torch.einsum("kai,ka->i", J, f), f.reshape(-1, 4, 3)

    def substep(self, st: dict, wind) -> dict:
        """One 1 kHz step of the plant under its targets and throttle."""
        st = dict(st)
        rb, dt, pl = self.robot, self.dt, self.plant_params
        T, Td = self.lstm.step(st["thrust_nn"], st["throttle"], dt)
        x, P = ekf_update(st["ekf_x"], st["ekf_P"], st["throttle"],
                          torch.stack([T, Td], -1), dt, self.R_ekf,
                          self.Q_ekf)
        st.update(thrust_nn=T, ekf_x=x, ekf_P=P)
        thrust = x[:, 0]
        kin = kinematics(rb, st["base_R"], st["base_p"], st["q"])
        nu = torch.cat([st["base_v"], st["qd"]])
        dyn = dynamics(rb, kin, nu, self.gravity)
        tau = torch.cat([torch.zeros(6, dtype=F64),
                         pl["kp"] * (st["q_des"] - st["q"])])
        p_j = kin.p[self.jets]
        f_j = (kin.R[self.jets] @ self.jet_axis) * thrust[:, None]
        tau = tau + torch.einsum(
            "kai,ka->i", point_jacobian(rb, kin, self.jets, p_j), f_j)
        tau = tau + torch.cat([_t(wind), torch.zeros(rb.n + 3, dtype=F64)])
        tau = tau + self._contact(kin, nu)[0]
        nu_dot = torch.linalg.solve(dyn.M + dt * torch.diag(self.D),
                                    tau - self.D * nu - dyn.h)
        nu = nu + dt * nu_dot
        st.update(base_v=nu[:6], qd=nu[6:],
                  base_p=st["base_p"] + dt * nu[0:3],
                  base_R=_exp(dt * nu[3:6]) @ st["base_R"],
                  q=st["q"] + dt * nu[6:])
        return st

    def plant(self, st: dict, joints_ref, throttle, wind) -> dict:
        """The tick's commands applied, then its substeps."""
        st = dict(st, q_des=_t(joints_ref), throttle=_t(throttle))
        for _ in range(self.substeps):
            st = self.substep(st, wind)
        return st

    # -- the controller --------------------------------------------------
    def controller(self, carry: dict) -> "oracle.OracleMPC":
        """``OracleMPC`` configured from this file's snapshot of the settled
        state, its state then set to the program's recorded controller
        carry in ``carry`` (a recorded start: ``carry.mpc.<field>`` arrays,
        lane first)."""
        m = self.config["mpc"]
        omp = oracle.OracleMPC(
            oracle_settings(self.config), self.snapshot(self.start),
            self.sel, self.traj, self.alpha,
            self.start["throttle"].numpy(),
            lambda_option=m["joints_lambda_option"],
            use_jet_dynamic=m["use_jet_dynamic"],
            use_estimated_thrust=m["use_estimated_thrust"])

        def c(name):
            return np.asarray(carry[f"carry.mpc.{name}"][0], np.float64)

        omp.rpy_old, omp.n_turns = c("rpy_old"), c("n_turns")
        omp.ref_counter = int(c("ref_counter"))
        omp.throttle_counter = int(c("throttle_counter"))
        omp.win_pos, omp.win_lin = c("pos_com_ref"), c("lin_mom_ref")
        omp.win_rpy, omp.win_ang = c("rpy_ref"), c("ang_mom_ref")
        omp.pos_ref_now, omp.rpy_ref_now = (c("pos_com_ref_now"),
                                            c("rpy_ref_now"))
        omp.pos_traj_idx = int(c("pos_traj_idx"))
        omp.alpha_idx = int(c("alpha_traj_idx"))
        omp.thrust_des, omp.thrust_dot_des = (c("thrust_des"),
                                              c("thrust_dot_des"))
        omp.throttle_cmd, omp.joints_pos_ref = (c("throttle_cmd"),
                                                c("joints_pos_ref"))
        return omp


def solve_from(omp, d: dict, prev: dict) -> dict:
    """The commands of one tick's exact solve from the update ``d``, started
    from the commands ``prev`` of the tick before (joint references,
    throttle, thrust and its rate)."""
    d = dict(d)
    joints = np.asarray(prev["joints_pos_ref"], np.float64)
    d.update(joints_pos_ref_prev=joints, joint_pos_ctrl=joints[omp.sel],
             throttle_cmd=np.asarray(prev["throttle"], np.float64),
             thrust_des=np.asarray(prev["thrust_des"], np.float64),
             thrust_dot_des=np.asarray(prev["thrust_dot_des"], np.float64))
    out = oracle.assemble(d, omp.ocfg)
    n_ctrl = len(omp.sel)
    ch = omp.ocfg["control_horizon"]
    n_free = 0 if omp.ocfg.get("joint_limits", False) else n_ctrl * ch
    u = oracle.solve_box_qp(out["Hc"], out["qc"], out["lbc"], out["ubc"],
                            n_free=n_free)
    states = out["F"] @ u + out["f"]
    joints = joints.copy()
    joints[omp.sel] += u[:n_ctrl]
    v0 = u[n_ctrl * ch: n_ctrl * ch + 4]
    return dict(joints_pos_ref=joints,
                throttle=oracle._destd_throttle(v0),
                thrust_des=states[0, oracle.THRUST].copy(),
                thrust_dot_des=states[0, oracle.THRUSTDOT].copy())


def _numpy_state(st: dict) -> dict:
    return {k: st[k].detach().numpy().astype(np.float64)
            for k in PLANT_FIELDS}


def _observed(sd: dict) -> dict:
    return dict(com=sd["com_pos"], momentum=sd["momentum_body"])


def step_pass(config_path, start_path, carry_path, wind, ticks) -> list:
    """The reference beside one pass of the program, tick by tick, from the
    recorded start ``carry_path`` under the pass's ``wind`` [3]. ``ticks``
    [(check, state, before, applied)] in pass order from the pass's first
    tick: ``state`` the program's plant state at the tick's start ({field:
    array}), ``before`` and ``applied`` its commands of the tick before and
    of the tick ({command: array}), ``check`` whether the tick is
    compared. The controller's own update runs on every tick; a compared
    tick is solved from ``before``, and the plant stepped from ``state``
    under ``applied``. Returns [{observed, commands, next}] of the compared
    ticks, in order: the snapshot's CoM and body momentum, the commands,
    the plant state after the tick."""
    flight = Flight(config_path, np.load(start_path))
    omp = flight.controller(np.load(carry_path))
    out = []
    for check, state, prev, applied in ticks:
        st = {k: _t(v) for k, v in state.items()}
        sd = flight.snapshot(st)
        d = omp._prep(sd, np.asarray(state["ekf_x"])[:, 1])
        if not check:
            continue
        cmds = solve_from(omp, d, prev)
        nxt = flight.plant(st, applied["joints_pos_ref"],
                           applied["throttle"], wind)
        out.append(dict(observed=_observed(sd), commands=cmds,
                        next=_numpy_state(nxt)))
    return out


def chain_pass(config_path, start_path, carry_path, wind, n_ticks) -> list:
    """The reference's own closed loop of ``n_ticks`` ticks from the
    recorded start (``carry_path``'s plant state and controller carry)
    under the pass's ``wind`` [3]: [{observed, commands, next}] a tick, as
    :func:`step_pass` gives them."""
    flight = Flight(config_path, np.load(start_path))
    z = np.load(carry_path)
    omp = flight.controller(z)
    st = plant_state(z, "carry.plant")
    out = []
    for _ in range(n_ticks):
        sd = flight.snapshot(st)
        cmds = omp.tick(sd, st["ekf_x"][:, 1].numpy())
        st = flight.plant(st, cmds["joints_pos_ref"], cmds["throttle"], wind)
        out.append(dict(observed=_observed(sd),
                        commands={k: cmds[k] for k in COMMANDS},
                        next=_numpy_state(st)))
    return out


def step_pass_task(args):
    """:func:`step_pass` on one tuple of arguments, for a process pool."""
    torch.set_num_threads(1)
    return step_pass(*args)


def chain_pass_task(args):
    """:func:`chain_pass` on one tuple of arguments, for a process pool."""
    torch.set_num_threads(1)
    return chain_pass(*args)
