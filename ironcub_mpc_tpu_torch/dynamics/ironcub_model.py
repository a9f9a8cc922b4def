"""iRonCub-Mk3 robot model, calibrated to published figures.

The reference loads the real iRonCub-Mk3 URDF from the ``ironcub-models``
distribution (configMujoco.toml:2); that asset is not redistributable and is
absent here, so this module provides a 23-DOF model with the same topology,
joint names (robot.toml axesList), jet frames and floating-base convention
("chest", robot.toml ROBOT_COMMON), **calibrated to the published
iRonCub-Mk3 data**:

- **Total mass 70.0 kg** — the figure reported for iRonCub-Mk3 (the
  paper's platform, arXiv:2505.16478; IIT 2025 flight reports). The
  per-segment split is estimated from the iCub3 heritage platform
  (~52 kg structure) plus the flight hardware below.
- **4 × JetCat P250 jet turbines, 2.9 kg each**: two on the forearms
  (exhaust toward the hands) and two in a back-mounted jetpack. The
  identified thrust model shared with the reference (ops/jet_model.py,
  JetModel.cpp:13-26) saturates at ≈222 N steady thrust per turbine —
  the P250 class — and sustains 70 kg hover (171.7 N/jet) at ≈76 %
  throttle, inside the configured [0, 100] band.
- **Jetpack**: 11.8 kg fixed mass on the chest's back (6.0 kg structure +
  fuel + the two chest turbines), with the chest jet frames canted
  outward 10 degrees.

Geometry: z-up, x forward; segment lengths keep the iCub3 ~1.25 m scale.
Per-link inertias are solid-primitive estimates consistent with each
segment's mass and size. All algorithms are exact for whatever model is
supplied; :func:`load_ironcub_model` loads the committed calibrated URDF
through the reduction + re-rooting path (:mod:`.urdf`), exactly like the
reference's iDynTree loading (Robot.cpp:82-103), and is what the flagship
flight/bench paths use.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.config import RobotConfig
from .model import ModelBuilder, RobotModel

#: Committed calibrated URDF (authored rooted at root_link, like the real
#: asset; generated by tools/make_calibrated_urdf.py from
#: :func:`build_ironcub_model`).
CALIBRATED_URDF = str(
    Path(__file__).resolve().parents[2] / "data" / "ironcub_mk3_calibrated.urdf")

#: Published total mass the model is calibrated to [kg].
TOTAL_MASS_KG = 70.0

#: JetCat P250 turbine dry mass [kg] (per-unit; two on forearms, two in the
#: jetpack).
TURBINE_MASS_KG = 2.9


def build_ironcub_model(robot_cfg: RobotConfig | None = None) -> RobotModel:
    cfg = robot_cfg or RobotConfig()
    b = ModelBuilder("chest")
    b.set_root_inertial(mass=8.0, com=(0.0, 0.0, 0.03),
                        inertia_diag=(0.075, 0.055, 0.05))
    # head (fixed)
    b.add_link("head", "chest", None, origin_p=(0.0, 0.0, 0.12),
               mass=3.0, com=(0.02, 0.0, 0.08), inertia_diag=(0.024, 0.024, 0.018))
    # back-mounted jetpack: structure + fuel + the two chest turbines
    # (fixed link; the chest jet frames below sit at its outboard ends)
    b.add_link("jetpack", "chest", None, origin_p=(-0.075, 0.0, 0.0),
               mass=6.0 + 2.0 * TURBINE_MASS_KG, com=(0.0, 0.0, 0.0),
               inertia_diag=(0.10, 0.12, 0.09))

    # --- torso chain: chest -> pelvis (joints named bottom-up as in iCub) --
    b.add_link("torso_2", "chest", "torso_yaw", axis=(0, 0, 1),
               origin_p=(0.0, 0.0, -0.10), mass=2.0, com=(0.02, 0.0, -0.03),
               inertia_diag=(0.013, 0.013, 0.011))
    b.add_link("torso_1", "torso_2", "torso_roll", axis=(1, 0, 0),
               origin_p=(0.0, 0.0, -0.08), mass=2.0, com=(0.02, 0.0, -0.03),
               inertia_diag=(0.013, 0.013, 0.011))
    b.add_link("root_link", "torso_1", "torso_pitch", axis=(0, 1, 0),
               origin_p=(0.0, 0.0, -0.08), mass=7.0, com=(0.015, 0.0, -0.04),
               inertia_diag=(0.053, 0.044, 0.035))

    # --- legs -------------------------------------------------------------
    # Right-side roll/yaw axes are mirrored (as on the real robot) so the
    # shipped symmetric initial posture (configMujoco.toml:11-33, equal
    # values for both legs) produces a symmetric stance. Each leg joint's
    # origin also pre-rotates by minus the shipped initial angle — the
    # initial posture is the neutral standing pose of this model, which
    # puts the soles flat under the hips.
    leg_neutral = {"hip_pitch": 19.6, "hip_roll": 8.43, "hip_yaw": 4.64,
                   "knee": 0.0, "ankle_pitch": 1.71, "ankle_roll": -8.33}

    def neutral_rpy(axis, deg):
        a = np.asarray(axis, float)
        return tuple(-np.radians(deg) * a)

    for side, sy in (("l", 1.0), ("r", -1.0)):
        hip = f"{side}_hip"
        ax_roll = (sy, 0, 0)
        ax_yaw = (0, 0, sy)
        b.add_link(f"{hip}_1", "root_link", f"{side}_hip_pitch", axis=(0, 1, 0),
                   origin_p=(0.0, sy * 0.07, -0.08),
                   origin_rpy=neutral_rpy((0, 1, 0), leg_neutral["hip_pitch"]),
                   mass=2.0, com=(0, 0, -0.02),
                   inertia_diag=(0.007, 0.007, 0.005))
        b.add_link(f"{hip}_2", f"{hip}_1", f"{side}_hip_roll", axis=ax_roll,
                   origin_rpy=neutral_rpy(ax_roll, leg_neutral["hip_roll"]),
                   mass=0.9, com=(0, 0, -0.02),
                   inertia_diag=(0.004, 0.004, 0.004))
        b.add_link(f"{side}_upper_leg", f"{hip}_2", f"{side}_hip_yaw",
                   axis=ax_yaw,
                   origin_rpy=neutral_rpy(ax_yaw, leg_neutral["hip_yaw"]),
                   mass=3.4, com=(0.01, 0, -0.10),
                   inertia_diag=(0.031, 0.031, 0.006))
        b.add_link(f"{side}_lower_leg", f"{side}_upper_leg", f"{side}_knee",
                   axis=(0, 1, 0), origin_p=(0.0, 0.0, -0.20), mass=2.4,
                   com=(0.01, 0, -0.09), inertia_diag=(0.019, 0.019, 0.003))
        b.add_link(f"{side}_ankle_1", f"{side}_lower_leg",
                   f"{side}_ankle_pitch", axis=(0, 1, 0),
                   origin_p=(0.0, 0.0, -0.20),
                   origin_rpy=neutral_rpy((0, 1, 0), leg_neutral["ankle_pitch"]),
                   mass=1.0, com=(0, 0, -0.02),
                   inertia_diag=(0.003, 0.003, 0.003))
        b.add_link(f"{side}_foot", f"{side}_ankle_1", f"{side}_ankle_roll",
                   axis=ax_roll,
                   origin_rpy=neutral_rpy(ax_roll, leg_neutral["ankle_roll"]),
                   mass=0.9, com=(0.03, 0, -0.03),
                   inertia_diag=(0.003, 0.006, 0.006))
        b.add_frame(f"{side}_sole", f"{side}_foot", p=(0.01, 0.0, -0.05))

    # --- arms + forearm jet turbines --------------------------------------
    for side, sy in (("l", 1.0), ("r", -1.0)):
        sh = f"{side}_shoulder"
        b.add_link(f"{sh}_1", "chest", f"{side}_shoulder_pitch", axis=(0, 1, 0),
                   origin_p=(0.0, sy * 0.15, 0.04), mass=1.0,
                   com=(0, sy * 0.02, 0), inertia_diag=(0.003, 0.003, 0.003))
        b.add_link(f"{sh}_2", f"{sh}_1", f"{side}_shoulder_roll",
                   axis=(sy, 0, 0), mass=0.7, com=(0, 0, -0.02),
                   inertia_diag=(0.003, 0.003, 0.003))
        b.add_link(f"{side}_upper_arm", f"{sh}_2", f"{side}_shoulder_yaw",
                   axis=(0, 0, sy), mass=1.6, com=(0, 0, -0.08),
                   inertia_diag=(0.008, 0.008, 0.003))
        # forearm carries the arm jet turbine (TURBINE_MASS_KG of the link
        # mass, CoM pulled toward the turbine mount)
        b.add_link(f"{side}_forearm", f"{side}_upper_arm", f"{side}_elbow",
                   axis=(0, 1, 0), origin_p=(0.0, 0.0, -0.15),
                   mass=1.3 + TURBINE_MASS_KG,
                   com=(0.0, 0.0, -0.09), inertia_diag=(0.02, 0.02, 0.005))
        # jet frame: flipped so the thrust axis (local -z, Robot.cpp:184)
        # points up along the forearm — exhaust toward the hand
        b.add_frame(f"{side}_arm_jet_turbine", f"{side}_forearm",
                    p=(0.0, 0.0, -0.12), rpy=(np.pi, 0.0, 0.0))

    # jetpack turbines, flipped (thrust up) and canted outward 10°
    # turbines nestle against the back so their thrust line sits at the
    # same pitch lever as the forearm jets' (|x - CoM| ~ 0.06 m both):
    # the hover trim then shares load near-equally, ~172 N/jet at 70 kg —
    # mid-envelope for the identified P250-class model, with headroom on
    # every turbine (a rear-heavy placement pinned the arm jets at 100%
    # throttle / 222 N for the whole mission)
    b.add_frame("chest_l_jet_turbine", "jetpack", p=(0.015, 0.09, 0.02),
                rpy=(np.pi - np.radians(10.0), 0.0, 0.0))
    b.add_frame("chest_r_jet_turbine", "jetpack", p=(0.015, -0.09, 0.02),
                rpy=(np.pi + np.radians(10.0), 0.0, 0.0))

    return b.build(joint_order=cfg.axes_list)


def load_ironcub_model(robot_cfg: RobotConfig | None = None,
                       urdf_path: str | None = None) -> RobotModel:
    """Load the calibrated iRonCub-Mk3 URDF through the reduction +
    re-rooting path — the reference's model-loading contract
    (Robot.cpp:82-103: loadReducedModelFromFile + setFloatingBase).

    The committed URDF is authored rooted at ``root_link`` (as the real
    asset is), so loading it re-roots the torso chain at the configured
    ``base_frame`` ("chest"). Pass ``urdf_path`` to load the real
    iRonCub-Mk3 asset instead when available.
    """
    from .urdf import load_urdf
    cfg = robot_cfg or RobotConfig()
    return load_urdf(urdf_path or CALIBRATED_URDF, cfg.axes_list,
                     cfg.base_frame)
