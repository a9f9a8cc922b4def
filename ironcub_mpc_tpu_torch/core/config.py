"""Typed configuration tree for the multi-rate MPC framework.

The reference scatters configuration across three formats (YARP
robotinterface XML for MPC params, TOML for robot/sim; see
``src/config/vs_mcp_config.xml``, ``robot.toml``, ``configMujoco.toml``).
Here everything is a frozen dataclass so a config is hashable and can be a
static argument to ``jax.jit``; every parameter name from the reference
config files is preserved (as a snake_cased field with the original name in
the loader) so reference configs load unmodified.
"""

from __future__ import annotations

import dataclasses
import math
import re
import tomllib
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Tuple


# ---------------------------------------------------------------------------
# MPC configuration (reference: vs_mcp_config.xml:7-43, group VS_MPC_CONFIG)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    # flags
    enable_debug_log_mode: bool = False        # enableDebugLogMode
    use_jet_dynamic: bool = True               # useJetDynamic
    use_estimated_thrust: bool = True          # useEstimatedThrust
    # periods [s]
    period_mpc: float = 0.005                  # periodMPC
    period_mpc_large_steps: float = 0.1        # periodMPCLargeSteps
    period_mpc_small_steps: float = 0.005      # periodMPCSmallSteps
    # horizon
    n_iter: int = 17                           # nIter
    n_iter_small: int = 7                      # nIterSmall
    control_horizon: int = 12                  # controlHorizon
    controlled_joints: Tuple[str, ...] = (     # controlledJoints
        "l_shoulder_pitch", "l_shoulder_roll", "l_shoulder_yaw", "l_elbow",
        "r_shoulder_pitch", "r_shoulder_roll", "r_shoulder_yaw", "r_elbow",
    )
    joints_lambda_option: str = "unfiltered"   # jointsLambdaOption
    # weights
    weight_com_pos: Tuple[float, ...] = (500.0, 500.0, 5000.0)
    weight_com_pos_error: Tuple[float, ...] = (25000.0, 25000.0, 50000.0)
    weight_lin_mom: Tuple[float, ...] = (1.0, 1.0, 1.5)
    weight_rpy: Tuple[float, ...] = (1000.0, 1000.0, 1000.0)
    weight_rpy_error: Tuple[float, ...] = (10000.0, 10000.0, 10000.0)
    weight_ang_mom: Tuple[float, ...] = (80.0, 80.0, 80.0)
    weight_delta_joint: Tuple[float, ...] = (65000.0,) * 8
    weight_throttle: float = 80000.0           # weightThrottle
    weight_initial_throttle: float = 80000.0   # weightInitialThrottle
    weight_regularization_joint_pos: float = 20.0  # weightRegularizationJointPos
    # throttle bounds [%]
    throttle_min: float = 0.0                  # throttleMin
    throttle_max: float = 100.0                # throttleMax
    # joint position limits [deg] on the controlled joints. The reference
    # compiles a JointPositionConstraint block (constraintsVSMPC.cpp:388-468)
    # but never registers it (variableSamplingMPC.cpp:77-84); here it is a
    # config-gated, fully wired constraint (off by default for parity).
    use_joint_position_constraint: bool = False
    joint_pos_min_deg: Tuple[float, ...] = (-90.0,) * 8   # jointPos_min
    joint_pos_max_deg: Tuple[float, ...] = (90.0,) * 8    # jointPos_max
    # QP solve strategy (TPU-build extension; not in the reference config):
    # "condensed" — exact state elimination to a 120-var box QP (fast path);
    # "full"      — sparse-form 588x512 QP like the reference's OSQP setup.
    qp_solver: str = "condensed"
    # horizon condensing strategy (TPU-build extension): "assoc" composes
    # the per-knot affine maps with jax.lax.associative_scan (log₂(nIter)
    # parallel depth — the SURVEY §2.6 horizon-parallel axis, for long
    # horizons); "sequential" is the forward chain. Measured on TPU v5e
    # (tools/profile_solve_parts.py): the chain wins at every measured
    # point — nIter=17 batch 512: 3.9 vs 13.6 ms; nIter=128 batch 16:
    # 6.6 vs 91 ms; nIter=128 batch 1: 4.2 vs 4.9 ms (assoc pays
    # log2(nIter) levels ≈ 7x the FLOPs, and the batch axis already fills
    # the MXU). Sequential is the measurement-justified default; "assoc"
    # remains equivalence-tested for genuinely latency-bound long-horizon
    # single-robot cases on faster-dispatch hosts.
    condense_mode: str = "sequential"
    # trajectory files (groups TRAJECTORY_MANAGER / POSITION_TRAJECTORY)
    alpha_gravity_trajectory: str = "data/trajectories/alpha_gravity.npz"
    position_trajectory: str = "data/trajectories/minimum_jerk.npz"

    # --- derived sizes (variableSamplingMPC.cpp:42-45) ---------------------
    @property
    def n_states(self) -> int:
        return 26

    @property
    def n_ctrl_joints(self) -> int:
        return len(self.controlled_joints)

    @property
    def n_jets(self) -> int:
        return 4

    @property
    def n_throttle_knots(self) -> int:
        # controlHorizon - nIterSmall + 1 throttle knots (variableSamplingMPC.cpp:45)
        return self.control_horizon - self.n_iter_small + 1

    @property
    def n_var(self) -> int:
        return (self.n_states * (self.n_iter + 1)
                + self.n_ctrl_joints * self.control_horizon
                + self.n_jets * self.n_throttle_knots)

    @property
    def n_dynamics_constraints(self) -> int:
        return self.n_states * self.n_iter

    @property
    def n_throttle_constraints(self) -> int:
        # N_THRUSTS * (nIter - nIterSmall + 1)  (constraintsVSMPC.cpp:283)
        return self.n_jets * (self.n_iter - self.n_iter_small + 1)

    @property
    def n_joint_position_constraints(self) -> int:
        # declared rows: nJoints * nIter, of which only the first
        # controlHorizon knots are filled — same declared-vs-filled sizing
        # quirk as the throttle rows (constraintsVSMPC.cpp:393 vs :435)
        if not self.use_joint_position_constraint:
            return 0
        return self.n_ctrl_joints * self.n_iter

    @property
    def n_constraints(self) -> int:
        return (self.n_dynamics_constraints + self.n_states
                + self.n_throttle_constraints
                + self.n_joint_position_constraints)

    @property
    def joints_offset(self) -> int:
        """Column offset of the first joint-delta input variable."""
        return self.n_states * (self.n_iter + 1)

    @property
    def throttle_offset(self) -> int:
        """Column offset of the first throttle knot variable."""
        return self.joints_offset + self.n_ctrl_joints * self.control_horizon

    @property
    def ratio_small_large(self) -> int:
        # round(periodMPCLargeSteps / periodMPCSmallSteps)  (constraintsVSMPC.cpp:322)
        return round(self.period_mpc_large_steps / self.period_mpc_small_steps)

    @property
    def n_reference_knots(self) -> int:
        # rolling reference window width (costsVSMPC.cpp:96-99)
        return self.n_iter - self.n_iter_small + 1


# ---------------------------------------------------------------------------
# Robot configuration (reference: robot.toml)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    robot_port_name: str = "icubSim"
    axes_list: Tuple[str, ...] = (
        "torso_pitch", "torso_roll", "torso_yaw",
        "l_shoulder_pitch", "l_shoulder_roll", "l_shoulder_yaw", "l_elbow",
        "r_shoulder_pitch", "r_shoulder_roll", "r_shoulder_yaw", "r_elbow",
        "l_hip_pitch", "l_hip_roll", "l_hip_yaw", "l_knee",
        "l_ankle_pitch", "l_ankle_roll",
        "r_hip_pitch", "r_hip_roll", "r_hip_yaw", "r_knee",
        "r_ankle_pitch", "r_ankle_roll",
    )
    jets_list: Tuple[str, ...] = (
        "l_arm_jet_turbine", "r_arm_jet_turbine",
        "chest_l_jet_turbine", "chest_r_jet_turbine",
    )
    control_boards_names: Tuple[str, ...] = (
        "torso", "left_arm", "right_arm", "left_leg", "right_leg",
    )
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    com_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    threshold_normal_force_on_ground: float = 5.0
    read_zmp_from_estimator: bool = True
    base_frame: str = "chest"

    @property
    def n_joints(self) -> int:
        return len(self.axes_list)

    @property
    def n_jets(self) -> int:
        return len(self.jets_list)


# ---------------------------------------------------------------------------
# Simulation configuration (reference: configMujoco.toml)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimConfig:
    robot_model: str = ""                       # robot_model URI (optional)
    mujoco_model_path: str = ""                 # mujoco_model_path URI (optional)
    external_wrenches_list: Tuple[str, ...] = ("l_sole", "l_sole", "r_sole", "r_sole")
    use_nn_jet_dynamics: bool = True
    simulate_noise: bool = False
    timestep: float = 0.001                     # 1 kHz plant
    initial_position_deg: Tuple[float, ...] = (
        -0.0, -1.02, 0.0,
        -19.0, 18.68, 31.0, 15.0,
        -19.0, 18.68, 31.0, 15.0,
        19.6, 8.43, 4.64, 0.0, 1.71, -8.33,
        19.6, 8.43, 4.64, 0.0, 1.71, -8.33,
    )
    noise_std_base_vel: float = 0.015           # simulator Gaussian noise std


# ---------------------------------------------------------------------------
# Loaders: reference-format files -> typed configs
# ---------------------------------------------------------------------------

_BOOLS = {"true": True, "false": False}


def _parse_xml_value(text: str):
    """Parse a YARP robotinterface <param> payload.

    Handles scalars, quoted strings, booleans, and parenthesised lists of
    numbers or quoted strings, e.g. ``(500.0 500.0 5000.0)`` or
    ``("l_elbow", "r_elbow")`` (vs_mcp_config.xml:17,23).
    """
    t = text.strip()
    if t.lower() in _BOOLS:
        return _BOOLS[t.lower()]
    if t.startswith("(") and t.endswith(")"):
        inner = t[1:-1]
        items = [s for s in re.split(r"[,\s]+", inner) if s]
        return tuple(_parse_xml_value(i) for i in items)
    if t.startswith('"') and t.endswith('"'):
        return t[1:-1]
    try:
        i = int(t)
        return i
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        return t


def read_robotinterface_xml(path: str | Path, group: str = "VS_MPC_CONFIG") -> dict:
    """Read a YARP robotinterface XML config into nested dicts.

    Equivalent role to the reference's ``readXMLFile`` + YarpParametersHandler
    (FlightControlUtils.cpp:52-75), without YARP: plain ElementTree.
    """
    # The file carries a DOCTYPE pointing at yarp.it; ElementTree ignores
    # external DTDs, so plain parse is fine.
    root = ET.parse(str(path)).getroot()

    def collect(elem) -> dict:
        out = {}
        for child in elem:
            if child.tag == "param":
                out[child.attrib["name"]] = _parse_xml_value(child.text or "")
            elif child.tag == "group":
                out[child.attrib["name"]] = collect(child)
            else:
                out.update(collect(child))
        return out

    tree = collect(root)

    def find_group(d, name):
        if name in d and isinstance(d[name], dict):
            return d[name]
        for v in d.values():
            if isinstance(v, dict):
                r = find_group(v, name)
                if r is not None:
                    return r
        return None

    g = find_group(tree, group)
    if g is None:
        raise KeyError(f"group {group!r} not found in {path}")
    return g


def mpc_config_from_xml(path: str | Path, group: str = "VS_MPC_CONFIG") -> MPCConfig:
    """Build an :class:`MPCConfig` from a reference-format XML file."""
    p = read_robotinterface_xml(path, group)

    def traj(group_name, default):
        g = p.get(group_name)
        if isinstance(g, dict) and "trajectoryFile" in g:
            return str(g["trajectoryFile"])
        return default

    d = MPCConfig()
    return MPCConfig(
        enable_debug_log_mode=p.get("enableDebugLogMode", d.enable_debug_log_mode),
        use_jet_dynamic=p.get("useJetDynamic", d.use_jet_dynamic),
        use_estimated_thrust=p.get("useEstimatedThrust", d.use_estimated_thrust),
        period_mpc=float(p.get("periodMPC", d.period_mpc)),
        period_mpc_large_steps=float(p.get("periodMPCLargeSteps", d.period_mpc_large_steps)),
        period_mpc_small_steps=float(p.get("periodMPCSmallSteps", d.period_mpc_small_steps)),
        n_iter=int(p.get("nIter", d.n_iter)),
        n_iter_small=int(p.get("nIterSmall", d.n_iter_small)),
        control_horizon=int(p.get("controlHorizon", d.control_horizon)),
        controlled_joints=tuple(p.get("controlledJoints", d.controlled_joints)),
        joints_lambda_option=str(p.get("jointsLambdaOption", d.joints_lambda_option)),
        weight_com_pos=tuple(map(float, p.get("weightCoMPos", d.weight_com_pos))),
        weight_com_pos_error=tuple(map(float, p.get("weightCoMPosError", d.weight_com_pos_error))),
        weight_lin_mom=tuple(map(float, p.get("weightLinMom", d.weight_lin_mom))),
        weight_rpy=tuple(map(float, p.get("weightRPY", d.weight_rpy))),
        weight_rpy_error=tuple(map(float, p.get("weightRPYError", d.weight_rpy_error))),
        weight_ang_mom=tuple(map(float, p.get("weightAngMom", d.weight_ang_mom))),
        weight_delta_joint=tuple(map(float, p.get("weightDeltaJoint", d.weight_delta_joint))),
        weight_throttle=float(p.get("weightThrottle", d.weight_throttle)),
        weight_initial_throttle=float(p.get("weightInitialThrottle", d.weight_initial_throttle)),
        weight_regularization_joint_pos=float(
            p.get("weightRegularizationJointPos", d.weight_regularization_joint_pos)),
        throttle_min=float(p.get("throttleMin", d.throttle_min)),
        throttle_max=float(p.get("throttleMax", d.throttle_max)),
        use_joint_position_constraint=bool(
            p.get("useJointPositionConstraint",
                  "jointPos_min" in p and "jointPos_max" in p)),
        joint_pos_min_deg=tuple(map(float, p.get("jointPos_min",
                                                 d.joint_pos_min_deg))),
        joint_pos_max_deg=tuple(map(float, p.get("jointPos_max",
                                                 d.joint_pos_max_deg))),
        alpha_gravity_trajectory=traj("TRAJECTORY_MANAGER", d.alpha_gravity_trajectory),
        position_trajectory=traj("POSITION_TRAJECTORY", d.position_trajectory),
    )


def robot_config_from_toml(path: str | Path) -> RobotConfig:
    """Build a :class:`RobotConfig` from a reference-format robot.toml."""
    with open(path, "rb") as f:
        t = tomllib.load(f)
    d = RobotConfig()
    common = t.get("ROBOT_COMMON", {})
    return RobotConfig(
        robot_port_name=t.get("robotPortName", d.robot_port_name),
        axes_list=tuple(t.get("axesList", d.axes_list)),
        jets_list=tuple(t.get("jetsList", d.jets_list)),
        control_boards_names=tuple(t.get("controlBoardsNames", d.control_boards_names)),
        gravity=tuple(t.get("gravity", d.gravity)),
        com_offset=tuple(t.get("CoMOffset", d.com_offset)),
        threshold_normal_force_on_ground=float(
            t.get("thresholdNormalForceRobotOnTheGround", d.threshold_normal_force_on_ground)),
        read_zmp_from_estimator=bool(t.get("readZMPFromEstimator", d.read_zmp_from_estimator)),
        base_frame=common.get("baseFrame", d.base_frame),
    )


def sim_config_from_toml(path: str | Path) -> SimConfig:
    """Build a :class:`SimConfig` from a reference-format configMujoco.toml."""
    with open(path, "rb") as f:
        t = tomllib.load(f)
    d = SimConfig()
    ext = t.get("external_wrenches_list", list(d.external_wrenches_list))
    if isinstance(ext, str):
        ext = [ext]
    return SimConfig(
        robot_model=t.get("robot_model", d.robot_model),
        mujoco_model_path=t.get("mujoco_model_path", d.mujoco_model_path),
        external_wrenches_list=tuple(ext),
        use_nn_jet_dynamics=bool(t.get("use_nn_jet_dynamics", d.use_nn_jet_dynamics)),
        simulate_noise=bool(t.get("simulate_noise", d.simulate_noise)),
        initial_position_deg=tuple(map(float, t.get("intial_position", d.initial_position_deg))),
    )


def joint_selector(robot: RobotConfig, mpc: MPCConfig) -> Tuple[int, ...]:
    """Indices of the controlled joints inside the full axes list.

    Reference: name-based selector loop (variableSamplingMPC.cpp:46-56).
    """
    sel = []
    for name in mpc.controlled_joints:
        sel.append(robot.axes_list.index(name))
    return tuple(sel)
