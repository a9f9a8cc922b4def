"""The port's command sequence against the independent float64 oracle.

The mirror of ``tests/test_command_fidelity.py``'s synthetic half for the
PyTorch port: ``tests/golden_oracle.OracleMPC`` (float64 NumPy, each tick's
condensed QP solved exactly by an active-set method, sharing no code with
either package) and the port's ``qp/mpc.py`` tick consume the same 45-tick
synthetic snapshot stream (``test_command_fidelity._snapshot_dict`` /
``_trajectories``: two 20-tick throttle boundaries, two reference-window
shifts, a yaw wrap through ±π) and carry their own state. Four
configurations, as the JAX test: the condensed and the full-space solver on
the stock config, the constant-λ / commanded-thrust variant and the
joint-position constraint at ±3°.

The port runs on the CPU in float32 with ``kernel_mode="off"`` (the plain
twins of the CUDA kernels) and is held at the JAX test's tolerances, each
stated at its assert: joints 2e-3 rad, throttle 0.15 %, the same
throttle-update ticks, thrust_des 0.5 N, thrust_dot_des 2.0 N/s, the final
state 5e-2 of its scale, joint limits within 1e-3 rad.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from oracle_replay import assert_solved, oracle_mpc, outputs_of
from test_command_fidelity import (N_TICKS, _series, _snapshot_dict,
                                   _trajectories)
from test_torch_tick import one_torch_thread  # noqa: F401

from ironcub_mpc_tpu_torch.core.config import (MPCConfig, RobotConfig,
                                               joint_selector)
from ironcub_mpc_tpu_torch.core.types import RobotSnapshot
from ironcub_mpc_tpu_torch.horizon import build_schedule
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.qp import mpc

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
CONFIGS = ("condensed", "full", "constant-commanded", "joint-limits")


def config_of(name):
    if name == "condensed":
        return MPCConfig()
    if name == "full":
        return dataclasses.replace(MPCConfig(), qp_solver="full")
    if name == "joint-limits":
        return dataclasses.replace(MPCConfig(),
                                   use_joint_position_constraint=True,
                                   joint_pos_min_deg=(-3.0,) * 8,
                                   joint_pos_max_deg=(3.0,) * 8)
    return dataclasses.replace(MPCConfig(), joints_lambda_option="constant",
                               use_estimated_thrust=False)


def snapshot_of(sd) -> RobotSnapshot:
    """The port's one-lane snapshot of a float64 state dict (the body-frame
    allocation matrix as ``compute_snapshot`` gives it)."""
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32))[None]

    R = sd["w_R_b"]
    amom = np.zeros((6, 4))
    for i in range(4):
        amom[:3, i] = R.T @ sd["jet_axes_world"][i]
        amom[3:, i] = R.T @ np.cross(sd["jet_arms_world"][i],
                                     sd["jet_axes_world"][i])
    return RobotSnapshot(
        w_R_b=f(R), base_pos=f([0.0, 0.0, 0.5]),
        base_ang_vel_world=f(sd["base_ang_vel_world"]),
        com_pos=f(sd["com_pos"]), total_mass=f(sd["total_mass"]),
        momentum_body=f(sd["momentum_body"]),
        inertia_locked=f(sd["inertia_locked"]), amom_jets_body=f(amom),
        jet_axes_world=f(sd["jet_axes_world"]),
        jet_arms_world=f(sd["jet_arms_world"]),
        jac_jets_lin_joints=f(sd["jac_jets_lin_joints"]),
        jac_com_joints=f(sd["jac_com_joints"]),
        rel_jac_lin=f(sd["rel_jac_lin"]), rel_jac_ang=f(sd["rel_jac_ang"]),
        joint_pos=f(sd["joint_pos"]), jet_thrusts=f(sd["jet_thrusts"]))


@functools.lru_cache(maxsize=None)
def run(name):
    """(cfg, port outputs, oracle outputs) over the 45 synthetic ticks."""
    cfg = config_of(name)
    sched = build_schedule(cfg)
    sel = joint_selector(RobotConfig(), cfg)
    settings = admm.ADMMSettings(max_iter=400, polish=True,
                                 kernel_mode="off")

    # both controllers see bit-identical inputs: every field rounded through
    # float32 (what the port consumes) before the oracle gets it in float64
    def r32(a):
        return np.asarray(np.asarray(a, np.float32), np.float64)

    sds = [{k: r32(v) for k, v in _snapshot_dict(
        t, np.random.default_rng(100 + t),
        np.random.default_rng(200 + t)).items()}
        for t in range(N_TICKS + 1)]
    est_tds = [r32(0.5 * np.sin(0.3 * t + np.arange(4)))
               for t in range(N_TICKS)]
    channels = {k: r32(v) for k, v in _trajectories().items()}
    alpha = r32(np.linspace(0.55, 1.0, 400))
    initial_throttle = r32(np.full(4, 62.0))

    problem, carry = mpc.configure(
        cfg, sched, sel, snapshot_of(sds[0]), channels, alpha, settings,
        initial_throttle=torch.as_tensor(initial_throttle, dtype=torch.float32),
        device=CPU)
    omp = oracle_mpc(cfg, sds[0], sel, channels, alpha, initial_throttle)
    port_out, orc_out = [], []
    for t in range(N_TICKS):
        est = torch.as_tensor(est_tds[t], dtype=torch.float32)[None]
        carry, out = mpc.mpc_tick(cfg, sched, sel, settings, problem, carry,
                                  snapshot_of(sds[t + 1]), est)
        assert_solved(out, f"{name} tick {t}")
        port_out.append(outputs_of(out))
        orc_out.append(omp.tick(sds[t + 1], est_tds[t]))
    return cfg, port_out, orc_out


@pytest.fixture(params=CONFIGS)
def sequences(request):
    return run(request.param)


def test_joint_command_sequence(sequences):
    _, port, orc = sequences
    np.testing.assert_allclose(_series(port, "joints_pos_ref"),
                               _series(orc, "joints_pos_ref"), atol=2e-3)


def test_throttle_command_sequence(sequences):
    _, port, orc = sequences
    port_t, orc_t = _series(port, "throttle"), _series(orc, "throttle")
    np.testing.assert_allclose(port_t, orc_t, atol=0.15)
    # the multi-rate semantics: throttle updates on the same ticks only
    port_changes = np.any(np.abs(np.diff(port_t, axis=0)) > 1e-4, axis=1)
    orc_changes = np.any(np.abs(np.diff(orc_t, axis=0)) > 1e-4, axis=1)
    np.testing.assert_array_equal(port_changes, orc_changes)


def test_thrust_command_sequence(sequences):
    _, port, orc = sequences
    np.testing.assert_allclose(_series(port, "thrust_des"),
                               _series(orc, "thrust_des"), atol=0.5)
    np.testing.assert_allclose(_series(port, "thrust_dot_des"),
                               _series(orc, "thrust_dot_des"), atol=2.0)


def test_final_state_sequence(sequences):
    _, port, orc = sequences
    port_f, orc_f = _series(port, "final_state"), _series(orc, "final_state")
    scale = np.maximum(1.0, np.abs(orc_f).max(axis=0))
    assert np.max(np.abs(port_f - orc_f) / scale) < 5e-2


def test_joint_limits_respected():
    """With the joint-position constraint on, the integrated command stays
    inside the ±3° limits (within 1e-3 rad) once the controller has pulled
    the initial out-of-range posture back in (from tick 10 on)."""
    cfg, port, _ = run("joint-limits")
    sel = np.asarray(joint_selector(RobotConfig(), cfg))
    late = _series(port, "joints_pos_ref")[10:, sel]
    qmin = np.deg2rad(cfg.joint_pos_min_deg)
    qmax = np.deg2rad(cfg.joint_pos_max_deg)
    assert np.all(late >= qmin[None, :] - 1e-3)
    assert np.all(late <= qmax[None, :] + 1e-3)
