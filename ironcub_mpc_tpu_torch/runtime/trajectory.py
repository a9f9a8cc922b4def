"""Trajectory management: named time series with cursor-based playback
(counterpart of ``ironcub_mpc_tpu/runtime/trajectory.py``).

Load named channels, linear-interp upsample from file fps to the consumer
fps, advance a cursor each tick and hold the last sample at the end. Channels
are float64 numpy arrays on the host, as loaded; ``configure`` moves the ones
it needs onto the device once. File format is ``.npz``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class Trajectory(NamedTuple):
    """A bundle of equally-sampled named channels.

    channels: dict name -> [T, dim] array; fps: sampling rate.
    """

    channels: Dict[str, np.ndarray]
    fps: int

    @property
    def length(self) -> int:
        return max(int(v.shape[0]) for v in self.channels.values())

    def value(self, name: str, idx):
        """Channel value at cursor ``idx`` (clamped to the end, hold-last)."""
        arr = self.channels[name]
        i = np.clip(idx, 0, arr.shape[0] - 1)
        return np.take(arr, i, axis=0)

    def advance(self, idx):
        """Next cursor value, saturating at the last sample."""
        maxlen = self.length
        return np.minimum(idx + 1, maxlen - 1)


def upsample(values: np.ndarray, file_fps: float, des_fps: float) -> np.ndarray:
    """Linear-interpolation upsampling: for each source interval insert
    ``ratio`` interpolated samples; the final source sample is dropped
    (output length = (T-1)·ratio)."""
    ratio = int(des_fps / file_fps)
    if ratio <= 1:
        return values
    T = values.shape[0]
    out = []
    for i in range(T - 1):
        for k in range(ratio):
            out.append(values[i] + (values[i + 1] - values[i]) * (k / ratio))
    return np.asarray(out)


def load_npz(path: str, des_fps: float | None = None) -> Trajectory:
    """Load a ``.npz`` trajectory: one array per channel + scalar ``fps``.

    Channels with more than one sample are upsampled to ``des_fps`` when it
    differs from the file fps.
    """
    raw = np.load(path)
    fps = float(np.asarray(raw["fps"]).reshape(-1)[0])
    channels = {}
    for k in raw.files:
        if k == "fps":
            continue
        v = np.asarray(raw[k], dtype=np.float64)
        if v.ndim == 1:
            v = v[:, None]
        if des_fps is not None and des_fps != fps and v.shape[0] > 1:
            v = upsample(v, fps, des_fps)
        channels[k] = v
    return Trajectory(channels=channels, fps=int(des_fps or fps))
