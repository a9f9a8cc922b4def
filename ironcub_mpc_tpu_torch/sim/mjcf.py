"""MJCF generation from a :class:`~ironcub_mpc_tpu_torch.dynamics.model.RobotModel`
(a copy of ``ironcub_mpc_tpu/sim/mjcf.py``, numpy and scipy only; a test
holds its output equal to the source's).

Lets the host-MuJoCo simulation path (and the test oracles) run without the
proprietary iRonCub assets: the same model spec that drives the port's
kinodynamics is emitted as MuJoCo XML, optionally with a floor, joint
position actuators and jet sites.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from ..dynamics.model import RobotModel


def _quat(R) -> str:
    q = Rotation.from_matrix(R).as_quat()  # x,y,z,w
    return f"{q[3]} {q[0]} {q[1]} {q[2]}"


def mjcf_from_model(model: RobotModel, floor: bool = False,
                    actuators: bool = False, kp: float = 1500.0,
                    kd: float = 60.0, timestep: float = 0.001) -> str:
    """Emit MuJoCo XML for ``model``.

    With ``actuators=True`` every DOF gets a position servo (the reference
    MJCF's actuation scheme, driven via ``data.ctrl[:njoints]`` —
    ironcub_mujoco_simulator.py:390-391).
    """
    children = {i: [] for i in range(model.n_links)}
    for i, p in enumerate(model.parent_link):
        if p >= 0:
            children[p].append(i)
    frames_of_link = {}
    for name, fr in model.frames.items():
        frames_of_link.setdefault(fr.link, []).append((name, fr))

    def body_xml(i, indent):
        pad = "  " * indent
        name = model.link_names[i]
        pos = model.origin_p[i]
        s = (f'{pad}<body name="{name}" pos="{pos[0]} {pos[1]} {pos[2]}" '
             f'quat="{_quat(model.origin_R[i])}">\n')
        if i == 0:
            s += f'{pad}  <freejoint name="base"/>\n'
        j = model.joint_of_link[i]
        if j >= 0:
            a = model.joint_axis[i]
            s += (f'{pad}  <joint name="{model.joint_names[j]}" type="hinge" '
                  f'axis="{a[0]} {a[1]} {a[2]}" pos="0 0 0" damping="{kd}"/>\n')
        m = max(model.mass[i], 1e-9)
        c = model.com[i]
        w, V = np.linalg.eigh(model.inertia[i] + 1e-12 * np.eye(3))
        if np.linalg.det(V) < 0:
            V[:, 0] *= -1
        w = np.maximum(w, 1e-10)
        s += (f'{pad}  <inertial pos="{c[0]} {c[1]} {c[2]}" mass="{m}" '
              f'quat="{_quat(V)}" diaginertia="{w[0]} {w[1]} {w[2]}"/>\n')
        for fname, fr in frames_of_link.get(i, []):
            s += (f'{pad}  <site name="{fname}" '
                  f'pos="{fr.p[0]} {fr.p[1]} {fr.p[2]}" quat="{_quat(fr.R)}"/>\n')
            if "sole" in fname:
                s += (f'{pad}  <geom type="box" size="0.07 0.04 0.005" '
                      f'pos="{fr.p[0]} {fr.p[1]} {fr.p[2] + 0.005}" '
                      f'friction="0.8 0.005 0.0001"/>\n')
        for ch in children[i]:
            s += body_xml(ch, indent + 1)
        s += f"{pad}</body>\n"
        return s

    floor_xml = ('    <geom name="floor" type="plane" size="50 50 1" '
                 'friction="0.8 0.005 0.0001"/>\n') if floor else ""
    act = ""
    if actuators:
        act = "  <actuator>\n"
        for jn in model.joint_names:
            act += (f'    <position name="{jn}_servo" joint="{jn}" '
                    f'kp="{kp}"/>\n')
        act += "  </actuator>\n"
    return (
        '<mujoco model="ironcub_tpu">\n'
        f'  <option gravity="0 0 -9.81" timestep="{timestep}"/>\n'
        "  <worldbody>\n"
        + floor_xml
        + body_xml(0, 2)
        + "  </worldbody>\n"
        + act
        + "</mujoco>\n")
