"""Telemetry persistence and introspection (counterpart of
``ironcub_mpc_tpu/runtime/telemetry.py``).

The reference emits telemetry two ways: structured per-block channels over a
YARP ``VectorsCollectionServer`` (IMPCProblem.cpp:300-408) and a timestamped
``.mat`` dump of the driver-side arrays (variable_sampling_mpc.py:163-194).
Here the telemetry tensors of
:meth:`~ironcub_mpc_tpu_torch.runtime.loop.ClosedLoop.rollout` are the
single source; this module moves them to the host and flattens them to the
reference's ``.mat`` channel names (so reference analysis scripts work
unchanged), with the debug-mode per-block introspection the reference gates
behind ``enableDebugLogMode``.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from .loop import TickTelemetry

# TickTelemetry field -> reference .mat key (variable_sampling_mpc.py:164-188)
MAT_KEYS = {
    "com_position": "CoMPosition",
    "com_position_desired": "CoMPosition_desired",
    "base_orientation_desired": "base_orientation_desired",
    "base_position": "base_position",
    "base_orientation": "base_orientation",
    "base_lin_vel": "base_lin_vel",
    "base_ang_vel": "base_ang_vel",
    "base_lin_vel_filtered": "base_lin_vel_filtered",
    "base_ang_vel_filtered": "base_ang_vel_filtered",
    "joints_pos_meas": "joints_pos_meas",
    "joints_vel_meas": "joints_vel_meas",
    "joints_pos_ref": "joints_pos_ref",
    "linear_momentum": "linear_momentum",
    "angular_momentum": "angular_momentum",
    "momentum_reference": "momentum_reference",
    "estimated_thrust": "estimated_thrust",
    "estimated_thrust_dot": "estimated_thrust_dot",
    "thrust_desired": "thrust_desired",
    "thrust_desired_dot": "thrust_desired_dot",
    "alpha_gravity": "alpha_gravity",
    "throttle": "throttle",
    "solver_status": "solver_status",
    "pri_res": "pri_res",
    "dua_res": "dua_res",
    "zmp": "ZMP",
    "on_ground": "robot_on_ground",
    "ext_wrench_sum": "sum_external_wrenches",
}


DEBUG_BLOCK_NAMES = ("ReferenceTrackingCost", "RegualarizationCost",
                     "ThrottleInitialValueCost",
                     "JointPositionRegularizationCost")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_mat_dict(tel: "TickTelemetry", period: float = 0.005) -> dict:
    """Stacked telemetry -> reference-named numpy dict (+time_controller).

    Each channel keeps its shape: [T, ...] for one run, [T, B, ...] for a
    rollout of B lanes, of which ``core.types.tree_map(lambda v: v[:, i],
    tel)`` takes lane i. When the run was recorded with
    ``enable_debug_log_mode`` on, the per-block cost channels
    (``<block>::xHx_gx``, IMPCProblem.cpp:360-376) and the stacked
    ``lb ≤ Ax ≤ ub`` triples (:378-405) are included."""
    out = {}
    for field, key in MAT_KEYS.items():
        out[key] = _host(getattr(tel, field))
    n = out["CoMPosition"].shape[0]
    out["time_controller"] = np.arange(1, n + 1) * period
    dbg = getattr(tel, "debug", None)
    if dbg is not None:
        out["debug_total_cost"] = _host(dbg.total_cost)
        costs = _host(dbg.block_costs)
        for i, name in enumerate(DEBUG_BLOCK_NAMES):
            out[f"debug_{name}_xHx_gx"] = costs[..., i]
        out["debug_constraint_lb"] = _host(dbg.constraint_lb)
        out["debug_constraint_Ax"] = _host(dbg.constraint_ax)
        out["debug_constraint_ub"] = _host(dbg.constraint_ub)
    return out


def save_mat(tel: "TickTelemetry", path: str | None = None,
             period: float = 0.005, extra: dict | None = None) -> str:
    """Dump a run to ``.mat`` (timestamped by default, like the reference)."""
    import scipy.io

    if path is None:
        path = time.strftime("%Y-%m-%d_%H-%M-%S") + ".mat"
    data = to_mat_dict(tel, period)
    if extra:
        data.update(extra)
    scipy.io.savemat(path, data)
    return path
