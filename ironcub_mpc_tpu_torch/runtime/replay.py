"""Recorded-flight replay streams (counterpart of
``ironcub_mpc_tpu/runtime/replay.py``).

A stream holds T+1 :class:`RobotSnapshot` frames, the per-tick EKF
thrust-rate estimates and the trajectory/alphaGravity windows captured at
the recording handoff. **Tick t consumes snapshot t+1 and est_td[t]**:
frame 0 seeds ``configure``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.config import MPCConfig, RobotConfig, joint_selector
from ..core.types import RobotSnapshot
from ..horizon.schedule import build_schedule

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_STREAM = ROOT / "tests" / "golden" / "flight_snapshots.npz"


class FlightReplay(NamedTuple):
    cfg: object                      # the flight MPCConfig
    sched: object                    # HorizonSchedule
    sel: tuple                       # joint selector
    snaps: RobotSnapshot             # tensors [T+1, ...] f32
    est_td: torch.Tensor             # [T, 4] EKF thrust-rate per tick
    channels: dict                   # reference-trajectory windows (numpy)
    alpha: np.ndarray                # alphaGravity slice
    initial_throttle: torch.Tensor   # [4] applied throttle at handoff

    @property
    def n_ticks(self) -> int:
        return int(self.est_td.shape[0])

    def snap_of(self, t: int) -> RobotSnapshot:
        """Frame ``t`` as a one-lane snapshot (leading dimension 1)."""
        return RobotSnapshot(*(a[t:t + 1] for a in self.snaps))

    def tick_inputs(self, t: int, batch: int = 1, lane_jitter=None):
        """(snapshot, est_thrust_dot) of tick ``t`` for ``batch`` lanes:
        frame t+1 and est_td[t], with ``lane_jitter`` [batch, 6] added to
        each lane's momentum (the bench's per-lane perturbation)."""
        if t >= self.n_ticks:
            raise IndexError(f"tick {t} beyond the {self.n_ticks} recorded")
        snap = RobotSnapshot(*(a[t + 1].expand(batch, *a.shape[1:])
                               for a in self.snaps))
        if lane_jitter is not None:
            snap = snap._replace(momentum_body=snap.momentum_body
                                 + lane_jitter)
        return snap, self.est_td[t].expand(batch, 4)

    def configure(self, settings):
        """(problem, one-lane carry) configured from frame 0 with the
        recorded trajectory windows and applied throttle, on the stream's
        device."""
        from ..qp import mpc as vs_mpc

        return vs_mpc.configure(
            self.cfg, self.sched, self.sel, self.snap_of(0), self.channels,
            self.alpha, settings, initial_throttle=self.initial_throttle,
            device=self.est_td.device)


def load_flight_replay(path: str | Path = DEFAULT_STREAM,
                       device=None) -> FlightReplay:
    """Load a recorded stream with the flight configuration it was recorded
    under, onto ``device`` (``cuda`` unless the caller says otherwise)."""
    dev = resolve_device(device)
    npz = np.load(path)
    cfg = dataclasses.replace(MPCConfig(),
                              weight_regularization_joint_pos=200.0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    snaps = RobotSnapshot(**{f: f32(npz[f"snap_{f}"])
                             for f in RobotSnapshot._fields})
    return FlightReplay(
        cfg=cfg,
        sched=build_schedule(cfg),
        sel=joint_selector(RobotConfig(), cfg),
        snaps=snaps,
        est_td=f32(npz["est_td"]),
        channels={k: np.asarray(npz[f"ch_{k}"]) for k in
                  ("positionCoM", "velocityCoM", "RPY", "RPYDot")},
        alpha=np.asarray(npz["alpha"]),
        initial_throttle=f32(npz["initial_throttle"]),
    )
