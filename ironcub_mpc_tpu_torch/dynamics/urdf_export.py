"""Emit a URDF from a :class:`RobotModel`, rooted at an arbitrary link.

Exists to prove the ``Robot.cpp:77-103`` loading contract on realistic
topology: the real iRonCub URDF is authored rooted at ``root_link`` while
the controller floats the base at ``chest`` (robot.toml ROBOT_COMMON), so
:func:`ironcub_mpc_tpu_torch.dynamics.urdf.load_urdf` must re-root — traversing
revolute joints against their authored direction. This exporter produces
such a URDF from the procedural model (and would from any
:class:`RobotModel`), enabling an exact round-trip test without the
non-redistributable iRonCub asset.

Re-rooted revolute edges are exact: ``X_oldparent = X_oldchild ·
Rot(a,−q) · T_o⁻¹`` cannot be written as one URDF (origin, axis) pair when
the origin translation is off-axis, so the exporter emits a zero-mass
``<name>_axis_frame`` intermediate — revolute about ``−a`` at identity
origin, then the fixed offset ``T_o⁻¹`` — the same factorisation the loader
uses on re-root.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from .model import RobotModel


def _rpy(R):
    return Rotation.from_matrix(R).as_euler("xyz")


def _fmt(v):
    return " ".join(f"{x:.12g}" for x in np.asarray(v, float))


def _link_xml(out, name, mass=0.0, com=None, inertia=None):
    out.append(f'  <link name="{name}">')
    if mass > 0.0:
        I = np.asarray(inertia, float)
        out.append("    <inertial>")
        out.append(f'      <origin xyz="{_fmt(com)}" rpy="0 0 0"/>')
        out.append(f'      <mass value="{mass:.12g}"/>')
        out.append(
            f'      <inertia ixx="{I[0,0]:.12g}" ixy="{I[0,1]:.12g}" '
            f'ixz="{I[0,2]:.12g}" iyy="{I[1,1]:.12g}" iyz="{I[1,2]:.12g}" '
            f'izz="{I[2,2]:.12g}"/>')
        out.append("    </inertial>")
    out.append("  </link>")


def _joint_xml(out, name, jtype, parent, child, R, p, axis=None):
    out.append(f'  <joint name="{name}" type="{jtype}">')
    out.append(f'    <origin xyz="{_fmt(p)}" rpy="{_fmt(_rpy(R))}"/>')
    out.append(f'    <parent link="{parent}"/>')
    out.append(f'    <child link="{child}"/>')
    if axis is not None:
        out.append(f'    <axis xyz="{_fmt(axis)}"/>')
        out.append('    <limit lower="-3.14" upper="3.14" effort="100" '
                   'velocity="10"/>')
    out.append("  </joint>")


def model_to_urdf(model: RobotModel, urdf_root: str,
                  robot_name: str = "ironcub_export") -> str:
    """Serialize ``model`` as URDF XML rooted at ``urdf_root``."""
    root_idx = model.link_index(urdf_root)
    n = model.n_links

    # undirected adjacency over model edges (child-link index carries edge)
    adj = {i: [] for i in range(n)}
    for child in range(n):
        parent = model.parent_link[child]
        if parent >= 0:
            adj[parent].append((child, True))    # model direction
            adj[child].append((parent, False))   # reversed

    out = [f'<robot name="{robot_name}">']
    for i in range(n):
        _link_xml(out, model.link_names[i], model.mass[i], model.com[i],
                  model.inertia[i])

    seen = {root_idx}
    stack = [root_idx]
    while stack:
        cur = stack.pop()
        for nxt, fwd in adj[cur]:
            if nxt in seen:
                continue
            seen.add(nxt)
            stack.append(nxt)
            # the model edge data lives on the model-child link
            edge_link = nxt if fwd else cur
            R_o = model.origin_R[edge_link]
            p_o = model.origin_p[edge_link]
            jidx = model.joint_of_link[edge_link]
            cur_name = model.link_names[cur]
            nxt_name = model.link_names[nxt]
            if jidx < 0:
                if fwd:
                    _joint_xml(out, f"fix_{nxt_name}", "fixed", cur_name,
                               nxt_name, R_o, p_o)
                else:
                    _joint_xml(out, f"fix_{nxt_name}", "fixed", cur_name,
                               nxt_name, R_o.T, -R_o.T @ p_o)
            else:
                jname = model.joint_names[jidx]
                axis = model.joint_axis[edge_link]
                if fwd:
                    _joint_xml(out, jname, "revolute", cur_name, nxt_name,
                               R_o, p_o, axis)
                else:
                    mid = f"{nxt_name}_axis_frame"
                    _link_xml(out, mid)
                    _joint_xml(out, jname, "revolute", cur_name, mid,
                               np.eye(3), np.zeros(3), -axis)
                    _joint_xml(out, f"fix_{nxt_name}", "fixed", mid,
                               nxt_name, R_o.T, -R_o.T @ p_o)

    # named auxiliary frames (jets, soles, sensors) as fixed zero-mass links
    for fname, fr in model.frames.items():
        _link_xml(out, fname)
        _joint_xml(out, f"fix_{fname}", "fixed", model.link_names[fr.link],
                   fname, fr.R, fr.p)

    out.append("</robot>")
    return "\n".join(out) + "\n"
