"""URDF loading with model reduction — ``loadReducedModelFromFile`` parity.

Parses a URDF into :class:`~ironcub_mpc_tpu_torch.dynamics.model.RobotModel`,
keeping only the joints in an ordered DOF list (everything else is fused as
a fixed transform at its zero position, merging child inertia into the
parent), and re-rooting the tree at a chosen floating-base link — the exact
contract of the reference's model loading (utils/src/Robot.cpp:77-103 via
iDynTree ModelLoader + setFloatingBase).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from .model import Frame, RobotModel, reorder_joints


def _origin(elem):
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    o = elem.find("origin") if elem is not None else None
    if o is not None:
        if o.get("xyz"):
            xyz = np.array([float(v) for v in o.get("xyz").split()])
        if o.get("rpy"):
            rpy = np.array([float(v) for v in o.get("rpy").split()])
    return Rotation.from_euler("xyz", rpy).as_matrix(), xyz


def _inertial(link_elem):
    inertial = link_elem.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    R, p = _origin(inertial)
    ine = inertial.find("inertia")
    I = np.array([
        [float(ine.get("ixx")), float(ine.get("ixy", 0)), float(ine.get("ixz", 0))],
        [float(ine.get("ixy", 0)), float(ine.get("iyy")), float(ine.get("iyz", 0))],
        [float(ine.get("ixz", 0)), float(ine.get("iyz", 0)), float(ine.get("izz"))],
    ])
    # inertia given in the inertial frame -> rotate to link frame
    return mass, p, R @ I @ R.T


def load_urdf(path: str, joint_order: Tuple[str, ...],
              base_link: str) -> RobotModel:
    """Load ``path``, keep DOFs in ``joint_order``, root at ``base_link``."""
    root = ET.parse(path).getroot()

    links: Dict[str, dict] = {}
    for le in root.findall("link"):
        m, c, I = _inertial(le)
        links[le.get("name")] = dict(mass=m, com=c, inertia=I)

    # undirected adjacency of (joint, parent, child)
    joints = []
    for je in root.findall("joint"):
        jtype = je.get("type")
        R, p = _origin(je)
        axis_e = je.find("axis")
        axis = (np.array([float(v) for v in axis_e.get("xyz").split()])
                if axis_e is not None else np.array([0.0, 0.0, 1.0]))
        joints.append(dict(
            name=je.get("name"), type=jtype,
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"), R=R, p=p, axis=axis))

    keep = set(joint_order)
    for j in joints:
        if j["name"] in keep and j["type"] not in ("revolute", "continuous"):
            raise ValueError(f"kept joint {j['name']} is not revolute")

    # Build the tree rooted at base_link. URDF joints are directed
    # parent->child; re-rooting may traverse some joints child->parent, in
    # which case the transform and axis are inverted.
    adj: Dict[str, list] = {}
    for j in joints:
        adj.setdefault(j["parent"], []).append((j, True))
        adj.setdefault(j["child"], []).append((j, False))

    if base_link not in links:
        raise KeyError(f"base link {base_link!r} not in URDF")

    # BFS from the base; collect directed edges (parent_link, link, joint, fwd)
    order = [base_link]
    edges = {}
    seen = {base_link}
    stack = [base_link]
    while stack:
        cur = stack.pop()
        for j, fwd in adj.get(cur, []):
            nxt = j["child"] if fwd else j["parent"]
            if nxt in seen:
                continue
            seen.add(nxt)
            edges[nxt] = (cur, j, fwd)
            order.append(nxt)
            stack.append(nxt)

    # fuse links connected by non-kept joints into their (tree-)parent
    link_names = []
    parent_of = {}
    fused_into = {}       # urdf link -> (model link name, R, p) accumulated
    model_links = {}      # model link name -> inertial accumulators + frames

    def add_model_link(name, parent_model, joint, R, p, axis):
        link_names.append(name)
        model_links[name] = dict(
            parent=parent_model, joint=joint, R=R, p=p, axis=axis,
            mass=0.0, mcom=np.zeros(3), inertia=np.zeros((3, 3)))

    add_model_link(base_link, None, None, np.eye(3), np.zeros(3), np.zeros(3))
    fused_into[base_link] = (base_link, np.eye(3), np.zeros(3))

    for name in order[1:]:
        parent_urdf, j, fwd = edges[name]
        pm_name, pR, pp = fused_into[parent_urdf]
        if j["name"] in keep:
            if fwd:
                # accumulated fused transform of the parent chain, then the
                # joint: X_child = X_parent · (pR,pp) · (R_o,p_o) · Rot(a,q)
                R0 = pR @ j["R"]
                p0 = pp + pR @ j["p"]
                add_model_link(name, pm_name, j["name"], R0, p0,
                               np.asarray(j["axis"]))
                fused_into[name] = (name, np.eye(3), np.zeros(3))
            else:
                # Traversed backwards (re-rooting past a revolute joint):
                #   X_oldparent = X_oldchild · Rot(a, −q) · T_o⁻¹.
                # The rotation acts BEFORE the inverted offset — about the
                # axis through the old child's origin — so it cannot be
                # folded into a single (origin, axis) pair unless p_o lies
                # on the axis. Model the joint exactly: a model link at the
                # old child frame rotated by Rot(−a, q) (identity origin
                # beyond the accumulated chain), with the URDF link hanging
                # off it by the fixed offset T_o⁻¹ through the fused_into
                # machinery — the URDF link name then surfaces as a named
                # frame at its exact authored pose, like iDynTree keeps
                # link frames invariant under setFloatingBase.
                mid = name + "_axis"
                add_model_link(mid, pm_name, j["name"], pR, pp,
                               -np.asarray(j["axis"]))
                fused_into[name] = (mid, j["R"].T, -j["R"].T @ j["p"])
        else:
            if fwd:
                R_j, p_j = j["R"], j["p"]
            else:
                R_j = j["R"].T
                p_j = -j["R"].T @ j["p"]
            # fixed (or dropped) joint: fuse into the parent model link
            R0 = pR @ R_j
            p0 = pp + pR @ p_j
            fused_into[name] = (pm_name, R0, p0)

    # accumulate inertial data into model links
    for uname, (mname, R, p) in fused_into.items():
        m = links[uname]["mass"]
        c = links[uname]["com"]
        I = links[uname]["inertia"]
        ml = model_links[mname]
        c_m = p + R @ c
        ml["mass"] += m
        ml["mcom"] = ml["mcom"] + m * c_m
        ml["inertia"] = ml["inertia"] + R @ I @ R.T \
            + m * (np.dot(c_m, c_m) * np.eye(3) - np.outer(c_m, c_m))

    # finalize: convert accumulated inertia (about model-link origin) back to
    # about-CoM form
    names, parents, joint_of, oR, op, ax, mass, com, inertia = (
        [], [], [], [], [], [], [], [], [])
    joint_names = []
    for name in link_names:
        ml = model_links[name]
        names.append(name)
        parents.append(link_names.index(ml["parent"]) if ml["parent"] else -1)
        if ml["joint"] is not None:
            joint_of.append(len(joint_names))
            joint_names.append(ml["joint"])
        else:
            joint_of.append(-1)
        oR.append(ml["R"])
        op.append(ml["p"])
        ax.append(ml["axis"])
        m = ml["mass"]
        c = ml["mcom"] / m if m > 0 else np.zeros(3)
        I_o = ml["inertia"]
        I_c = I_o - m * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
        mass.append(m)
        com.append(c)
        inertia.append(I_c)

    frames = {}
    # every fused URDF link becomes a named frame on its model link
    for uname, (mname, R, p) in fused_into.items():
        if uname not in link_names:
            frames[uname] = Frame(link=link_names.index(mname), R=R, p=p)

    model = RobotModel(
        link_names=tuple(names), joint_names=tuple(joint_names),
        parent_link=tuple(parents), joint_of_link=tuple(joint_of),
        origin_R=np.stack(oR), origin_p=np.stack(op), joint_axis=np.stack(ax),
        mass=np.asarray(mass), com=np.stack(com), inertia=np.stack(inertia),
        frames=frames)
    return reorder_joints(model, tuple(joint_order))
