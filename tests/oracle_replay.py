"""The port's tick beside the float64 oracle on a recorded stream.

Shared by ``tests/test_torch_fidelity*.py`` (the port on the CPU) and
``chip_smoke.py``'s phase ``fidelity_tools`` (the port on the card): it
imports numpy, PyTorch, the port and ``tests/golden_oracle.py`` (numpy
only), never JAX.

- :func:`oracle_mpc` builds ``golden_oracle.OracleMPC`` under a config's
  weights and horizon;
- :func:`oracle_frames` reads a recorded stream's snapshots as the float64
  state dicts the oracle consumes;
- :func:`replay_against_oracle` chains the port's batch-1 tick over a
  stream loaded by ``runtime/replay.py`` beside the oracle and returns both
  command sequences;
- :func:`command_errors` reduces two sequences to the largest differences
  that ``tests/test_command_fidelity.py`` bounds on the recorded streams.
"""

from __future__ import annotations

import numpy as np

import golden_oracle as oracle

OUT_KEYS = ("joints_pos_ref", "throttle", "thrust_des", "thrust_dot_des",
            "final_state")
ORACLE_FIELDS = ("w_R_b", "base_ang_vel_world", "com_pos", "total_mass",
                 "momentum_body", "inertia_locked", "jet_axes_world",
                 "jet_arms_world", "jet_thrusts", "rel_jac_lin",
                 "rel_jac_ang", "jac_jets_lin_joints", "jac_com_joints",
                 "joint_pos")
# tests/test_command_fidelity.py:360-386: joints rad, throttle %, thrust N,
# thrust rate N/s; a throttle update is a step above CHANGE_TOL
RECORDED_TOL = dict(joints_pos_ref=2e-3, throttle=0.15, thrust_des=0.5,
                    thrust_dot_des=2.0)
CHANGE_TOL = 1e-3
MIN_CHANGES = 5
SOLVED_STATUSES = (1, 2)                  # SOLVED, SOLVED_INACCURATE


def oracle_mpc(cfg, sd0, sel, channels, alpha, initial_throttle):
    """``OracleMPC`` under the weights and horizon of ``cfg``."""
    ocfg = dict(
        n_iter=cfg.n_iter, n_iter_small=cfg.n_iter_small,
        control_horizon=cfg.control_horizon,
        dt_small=cfg.period_mpc_small_steps,
        dt_large=cfg.period_mpc_large_steps,
        w_com=np.asarray(cfg.weight_com_pos),
        w_com_err=np.asarray(cfg.weight_com_pos_error),
        w_lin=np.asarray(cfg.weight_lin_mom),
        w_rpy=np.asarray(cfg.weight_rpy),
        w_rpy_err=np.asarray(cfg.weight_rpy_error),
        w_ang=np.asarray(cfg.weight_ang_mom),
        w_dq=np.asarray(cfg.weight_delta_joint),
        w_throttle=cfg.weight_throttle,
        w_throttle0=cfg.weight_initial_throttle,
        w_jreg=cfg.weight_regularization_joint_pos,
        throttle_min=cfg.throttle_min, throttle_max=cfg.throttle_max,
        joint_limits=cfg.use_joint_position_constraint,
        joint_pos_min=np.deg2rad(cfg.joint_pos_min_deg),
        joint_pos_max=np.deg2rad(cfg.joint_pos_max_deg),
    )
    return oracle.OracleMPC(
        ocfg, sd0, np.asarray(sel), channels, alpha, initial_throttle,
        lambda_option=cfg.joints_lambda_option,
        use_jet_dynamic=cfg.use_jet_dynamic,
        use_estimated_thrust=cfg.use_estimated_thrust)


def oracle_frames(path):
    """The stream's frames as float64 state dicts, the oracle's input."""
    npz = np.load(path)
    n = npz["snap_w_R_b"].shape[0]
    return [{k: np.asarray(npz[f"snap_{k}"][t], np.float64)
             for k in ORACLE_FIELDS} for t in range(n)]


def outputs_of(out, lane=0):
    """A tick's commands of one lane as float64 numpy arrays."""
    return {k: getattr(out, k)[lane].detach().cpu().numpy().astype(np.float64)
            for k in OUT_KEYS}


def assert_solved(out, what):
    st = out.status.cpu().numpy()
    assert np.isin(st, SOLVED_STATUSES).all(), f"{what}: port status {st}"


def replay_against_oracle(replay, frames, settings, n_ticks):
    """(port outputs, oracle outputs) of ``n_ticks`` chained ticks of a
    stream at batch 1; the port's tick runs on the stream's device, the
    oracle on the host."""
    from ironcub_mpc_tpu_torch.qp import mpc

    problem, carry = replay.configure(settings)
    omp = oracle_mpc(replay.cfg, frames[0], replay.sel, {
        k: np.asarray(v, np.float64) for k, v in replay.channels.items()},
        np.asarray(replay.alpha, np.float64),
        replay.initial_throttle.cpu().numpy().astype(np.float64))
    est = replay.est_td.cpu().numpy().astype(np.float64)
    port_out, orc_out = [], []
    for t in range(n_ticks):
        snap, est_t = replay.tick_inputs(t)
        carry, out = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel,
                                  settings, problem, carry, snap, est_t)
        assert_solved(out, f"recorded tick {t}")
        port_out.append(outputs_of(out))
        orc_out.append(omp.tick(frames[t + 1], est[t]))
    return port_out, orc_out


def series(outs, key):
    return np.stack([o[key] for o in outs])


def throttle_changes(outs, tol=CHANGE_TOL):
    """[ticks − 1] bool: where a throttle command steps by more than
    ``tol``."""
    return np.any(np.abs(np.diff(series(outs, "throttle"), axis=0)) > tol,
                  axis=1)


def command_errors(port, orc):
    """{command: largest |port − oracle|} over a sequence, and whether the
    throttle-update ticks agree and how many there are."""
    errs = {k: float(np.abs(series(port, k) - series(orc, k)).max())
            for k in RECORDED_TOL}
    changes = throttle_changes(port)
    return errs, bool(np.array_equal(changes, throttle_changes(orc))), \
        int(changes.sum())
