"""Fixed-topology floating-base robot model description.

The reference delegates all model handling to iDynTree
(``Robot::configure`` loads a reduced URDF, utils/src/Robot.cpp:77-103).
Here the model is a plain static description — numpy arrays + python ints —
consumed by :mod:`.kinodynamics` as trace-time constants, so XLA sees a fixed
unrolled kinematic tree with no dynamic control flow.

Conventions:
- every link has a body-fixed frame; the root link's frame is the floating
  base ("chest" for iRonCub, robot.toml ROBOT_COMMON.baseFrame);
- joint ``j`` connects ``parent_link[child]`` to child link: the child frame
  at configuration q is ``X_parent · T_origin(j) · Rot(axis_j, q_j)``;
- link inertial data: mass, CoM in link frame, 3×3 rotational inertia about
  the CoM in link frame;
- named auxiliary frames (jets, soles, sensors) are fixed transforms on a
  link.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Frame:
    link: int
    R: np.ndarray  # [3,3] frame rotation in link frame
    p: np.ndarray  # [3] frame origin in link frame


@dataclasses.dataclass(frozen=True)
class RobotModel:
    link_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]          # ordered DOF list (= axesList order)
    parent_link: Tuple[int, ...]          # per link; -1 for the root
    joint_of_link: Tuple[int, ...]        # DOF index moving each link; -1 if fixed or root
    # static transform from parent-link frame to child-link frame at q=0
    origin_R: np.ndarray                  # [n_links, 3, 3]
    origin_p: np.ndarray                  # [n_links, 3]
    joint_axis: np.ndarray                # [n_links, 3] axis in child frame (0 for fixed)
    mass: np.ndarray                      # [n_links]
    com: np.ndarray                       # [n_links, 3] link-frame CoM
    inertia: np.ndarray                   # [n_links, 3, 3] about CoM, link frame
    frames: Dict[str, Frame]

    def __post_init__(self):
        # links must be topologically ordered (parent before child)
        for i, p in enumerate(self.parent_link):
            assert p < i, "links must be listed parents-first"

    @property
    def n_links(self) -> int:
        return len(self.link_names)

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def ancestor_joints(self, link: int) -> list:
        """DOF indices on the path root -> link (for Jacobian sparsity)."""
        out = []
        while link >= 0:
            j = self.joint_of_link[link]
            if j >= 0:
                out.append(j)
            link = self.parent_link[link]
        return out[::-1]

    def dof_mask(self) -> np.ndarray:
        """[n_links, n_joints] bool: joint j moves link i."""
        m = np.zeros((self.n_links, self.n_joints), bool)
        for i in range(self.n_links):
            for j in self.ancestor_joints(i):
                m[i, j] = True
        return m


class ModelBuilder:
    """Imperative helper to assemble a :class:`RobotModel` parents-first."""

    def __init__(self, root_name: str):
        self.link_names = [root_name]
        self.parent = [-1]
        self.joint_of_link = [-1]
        self.joint_names: list = []
        self.origin_R = [np.eye(3)]
        self.origin_p = [np.zeros(3)]
        self.axis = [np.zeros(3)]
        self.mass = [0.0]
        self.com = [np.zeros(3)]
        self.inertia = [np.zeros((3, 3))]
        self.frames: Dict[str, Frame] = {}

    def add_link(self, name: str, parent: str, joint: str | None,
                 axis=None, origin_p=(0, 0, 0), origin_rpy=(0, 0, 0),
                 mass=0.0, com=(0, 0, 0), inertia_diag=(0, 0, 0)) -> str:
        """Attach ``name`` under ``parent`` via a revolute joint (or fixed if
        ``joint`` is None)."""
        from scipy.spatial.transform import Rotation

        self.link_names.append(name)
        self.parent.append(self.link_names.index(parent))
        if joint is None:
            self.joint_of_link.append(-1)
            self.axis.append(np.zeros(3))
        else:
            self.joint_of_link.append(len(self.joint_names))
            self.joint_names.append(joint)
            self.axis.append(np.asarray(axis, float))
        self.origin_R.append(
            Rotation.from_euler("xyz", origin_rpy).as_matrix())
        self.origin_p.append(np.asarray(origin_p, float))
        self.mass.append(float(mass))
        self.com.append(np.asarray(com, float))
        self.inertia.append(np.diag(np.asarray(inertia_diag, float)))
        return name

    def set_root_inertial(self, mass, com, inertia_diag):
        self.mass[0] = float(mass)
        self.com[0] = np.asarray(com, float)
        self.inertia[0] = np.diag(np.asarray(inertia_diag, float))

    def add_frame(self, name: str, link: str, p=(0, 0, 0), rpy=(0, 0, 0)):
        from scipy.spatial.transform import Rotation

        self.frames[name] = Frame(
            link=self.link_names.index(link),
            R=Rotation.from_euler("xyz", rpy).as_matrix(),
            p=np.asarray(p, float))

    def build(self, joint_order: Tuple[str, ...] | None = None) -> RobotModel:
        """Finalise; optionally re-order DOFs to ``joint_order`` (the
        reference's axesList contract, Robot.cpp:82-103)."""
        model = RobotModel(
            link_names=tuple(self.link_names),
            joint_names=tuple(self.joint_names),
            parent_link=tuple(self.parent),
            joint_of_link=tuple(self.joint_of_link),
            origin_R=np.stack(self.origin_R),
            origin_p=np.stack(self.origin_p),
            joint_axis=np.stack(self.axis),
            mass=np.asarray(self.mass),
            com=np.stack(self.com),
            inertia=np.stack(self.inertia),
            frames=dict(self.frames),
        )
        if joint_order is not None:
            model = reorder_joints(model, tuple(joint_order))
        return model


def reorder_joints(model: RobotModel, joint_order: Tuple[str, ...]) -> RobotModel:
    """Renumber DOFs to match an ordered joint-name list."""
    assert set(joint_order) == set(model.joint_names), (
        set(joint_order) ^ set(model.joint_names))
    old_of_new = [model.joint_names.index(n) for n in joint_order]
    new_of_old = {o: n for n, o in enumerate(old_of_new)}
    return dataclasses.replace(
        model,
        joint_names=tuple(joint_order),
        joint_of_link=tuple(
            new_of_old[j] if j >= 0 else -1 for j in model.joint_of_link),
    )
