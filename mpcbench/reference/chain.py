"""The float64 reference of a cell: the frozen oracle over a stream.

NumPy only. It reads a configuration file and a stream file of this
benchmark and nothing of the program: the joint selector, the oracle's
weights and horizon, the frames and the trajectory windows all come from
those two files. The controller's own state (reference-window shifts, the
10 Hz throttle pin, RPY unwrapping, the alphaGravity cursor) is worked out
again by :class:`golden_oracle.OracleMPC`'s update, tick after tick.

Two uses:

- :func:`run_lane` chains the oracle's whole tick over a stream: each
  tick's QP solved exactly, its commands integrated into the next tick's
  state. It shows how far the program's commands drift from the exact
  chain over a pass.
- :func:`step_lane` follows the program step by step: each compared tick
  starts from the commands the program gave on the tick before it (joint
  references, throttle, thrust and thrust rate, which the program's next
  tick reads back) and from the oracle's own update of everything else,
  and solves that tick's QP exactly. The gap is then the tick's own error,
  not the chain's drift.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import golden_oracle as oracle

ORACLE_FIELDS = ("w_R_b", "base_ang_vel_world", "com_pos", "total_mass",
                 "momentum_body", "inertia_locked", "jet_axes_world",
                 "jet_arms_world", "jet_thrusts", "rel_jac_lin",
                 "rel_jac_ang", "jac_jets_lin_joints", "jac_com_joints",
                 "joint_pos")
COMMANDS = ("joints_pos_ref", "throttle", "thrust_des", "thrust_dot_des")
OUTPUTS = COMMANDS + ("final_state",)
WIDTHS = dict(joints_pos_ref=23, throttle=4, thrust_des=4, thrust_dot_des=4,
              final_state=26)
CHANNELS = ("positionCoM", "velocityCoM", "RPY", "RPYDot")


def columns() -> dict:
    """Where each output lies in a row of the program's outputs."""
    out, at = {}, 0
    for k in OUTPUTS:
        out[k] = slice(at, at + WIDTHS[k])
        at += WIDTHS[k]
    return out


def load_config(path) -> dict:
    return json.loads(Path(path).read_text())


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


def joint_selector(config: dict) -> np.ndarray:
    """Indices of the controlled joints in the robot's axes list, by name."""
    axes = list(config["robot"]["axes_list"])
    return np.asarray([axes.index(n)
                       for n in config["mpc"]["controlled_joints"]], np.int64)


def frame(npz, t: int, jitter=None) -> dict:
    """Frame ``t`` as the oracle's float64 state dict. ``jitter`` [6] is
    added to the momentum in float32, as the program receives it."""
    d = {k: np.asarray(npz[f"snap_{k}"][t], np.float64)
         for k in ORACLE_FIELDS}
    if jitter is not None:
        mom = (npz["snap_momentum_body"][t].astype(np.float32)
               + np.asarray(jitter, np.float32))
        d["momentum_body"] = mom.astype(np.float64)
    return d


def _oracle(config, npz):
    m = config["mpc"]
    return oracle.OracleMPC(
        oracle_settings(config), frame(npz, 0), joint_selector(config),
        {k: np.asarray(npz[f"ch_{k}"], np.float64) for k in CHANNELS},
        np.asarray(npz["alpha"], np.float64),
        np.asarray(npz["initial_throttle"], np.float64),
        lambda_option=m["joints_lambda_option"],
        use_jet_dynamic=m["use_jet_dynamic"],
        use_estimated_thrust=m["use_estimated_thrust"])


def _set_commands(omp, cmds: dict) -> None:
    omp.joints_pos_ref = np.asarray(cmds["joints_pos_ref"], np.float64).copy()
    omp.throttle_cmd = np.asarray(cmds["throttle"], np.float64).copy()
    omp.thrust_des = np.asarray(cmds["thrust_des"], np.float64).copy()
    omp.thrust_dot_des = np.asarray(cmds["thrust_dot_des"],
                                    np.float64).copy()


def run_lane(config_path, stream_path, jitter, lead_in: int,
             start_commands: dict, n_ticks: int) -> dict:
    """The chained reference's outputs of one lane on ticks ``lead_in`` to
    ``lead_in + n_ticks - 1``: {output: [n_ticks, width]}. The lead-in
    ticks run as the oracle's own, then ``start_commands`` (the program's
    commands at the end of the lead-in) replace its commands."""
    config = load_config(config_path)
    npz = np.load(stream_path)
    est = np.asarray(npz["est_td"], np.float64)
    omp = _oracle(config, npz)
    for t in range(lead_in):
        omp.tick(frame(npz, t + 1, jitter), est[t])
    if lead_in:
        _set_commands(omp, start_commands)
    outs = [omp.tick(frame(npz, t + 1, jitter), est[t])
            for t in range(lead_in, lead_in + n_ticks)]
    return {k: np.stack([o[k] for o in outs]) for k in OUTPUTS}


def _solve(omp, d: dict) -> dict:
    """One tick's exact solve from the update ``d`` (the tail of
    ``OracleMPC.tick``, with the commands it starts from in ``d``)."""
    out = oracle.assemble(d, omp.ocfg)
    n_ctrl = len(omp.sel)
    ch = omp.ocfg["control_horizon"]
    n_free = 0 if omp.ocfg.get("joint_limits", False) else n_ctrl * ch
    u = oracle.solve_box_qp(out["Hc"], out["qc"], out["lbc"], out["ubc"],
                            n_free=n_free)
    states = out["F"] @ u + out["f"]
    joints = d["joints_pos_ref_prev"].copy()
    joints[omp.sel] += u[:n_ctrl]
    v0 = u[n_ctrl * ch: n_ctrl * ch + 4]
    return dict(joints_pos_ref=joints,
                throttle=oracle._destd_throttle(v0),
                thrust_des=states[0, oracle.THRUST].copy(),
                thrust_dot_des=states[0, oracle.THRUSTDOT].copy(),
                final_state=states[-1].copy())


def step_lane(config_path, stream_path, jitter, cases) -> list:
    """The reference's outputs of one lane on ``cases`` [(stream tick t,
    the program's outputs on the tick before, {command: array})], each
    solved from those commands: [{output: array}] in the order of
    ``cases``. The oracle's update runs once over every tick up to the
    last case; its commands are never its own."""
    config = load_config(config_path)
    npz = np.load(stream_path)
    est = np.asarray(npz["est_td"], np.float64)
    omp = _oracle(config, npz)
    last = max(t for t, _ in cases)
    updates = []
    for t in range(last + 1):
        updates.append(omp._prep(frame(npz, t + 1, jitter), est[t]))
    results = []
    for t, prev in cases:
        d = dict(updates[t])
        joints = np.asarray(prev["joints_pos_ref"], np.float64)
        d.update(joints_pos_ref_prev=joints,
                 joint_pos_ctrl=joints[omp.sel],
                 throttle_cmd=np.asarray(prev["throttle"], np.float64),
                 thrust_des=np.asarray(prev["thrust_des"], np.float64),
                 thrust_dot_des=np.asarray(prev["thrust_dot_des"],
                                           np.float64))
        results.append(_solve(omp, d))
    return results


def run_lane_task(args):
    """:func:`run_lane` on one tuple of arguments, for a process pool."""
    return run_lane(*args)


def step_lane_task(args):
    """:func:`step_lane` on one tuple of arguments, for a process pool."""
    return step_lane(*args)
