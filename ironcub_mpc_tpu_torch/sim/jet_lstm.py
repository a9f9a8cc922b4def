"""Learned plant-side jet dynamics: LSTM(2→80) + FC(80→1), batched over jets
(counterpart of ``ironcub_mpc_tpu/sim/jet_lstm.py``).

Per step the network sees [thrust_norm, throttle_norm] with a *zero* initial
hidden state (the identified model is fed one sample at a time with no
carried state, so the LSTM degenerates to a gated feed-forward cell),
predicts normalised Ṫ, and T integrates explicitly. The cell is one matmul
over all jets and lanes at once. Weights load from
``data/jet_lstm_weights.npz``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .. import resolve_device


class LSTMJetModel(torch.nn.Module):
    """Stateless LSTM jet-thrust model; the weights are buffers.
    ``weights`` is the path of an ``.npz`` file or a mapping with its keys."""

    def __init__(self, weights="data/jet_lstm_weights.npz",
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        raw = weights if isinstance(weights, Mapping) else np.load(weights)

        def buf(name, a):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(a), dtype=dtype, device=dev))

        buf("w_ih", raw["w_ih"])                   # [4H, 2]
        buf("w_hh", raw["w_hh"])                   # [4H, H]
        buf("b", raw["b_ih"] + raw["b_hh"])        # [4H]
        buf("fc_w", raw["fc_w"])                   # [1, H]
        buf("fc_b", raw["fc_b"])                   # [1]
        self.thrust_mean = float(raw["thrust_mean"])
        self.thrust_std = float(raw["thrust_std"])
        self.throttle_mean = float(raw["throttle_mean"])
        self.throttle_std = float(raw["throttle_std"])
        self.hidden = self.w_hh.shape[1]

    def _cell(self, x):
        """Zero-state LSTM cell + FC head. x: [..., 2] -> Ṫ_norm [...]."""
        gates = x @ self.w_ih.T + self.b                  # [..., 4H]
        H = self.hidden
        # 1/(1 + exp(−x)) written out, as the reference cell computes it
        i = torch.reciprocal(1.0 + torch.exp(-gates[..., 0:H]))
        # forget gate unused with zero cell state
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.reciprocal(1.0 + torch.exp(-gates[..., 3 * H:4 * H]))
        c = i * g
        h = o * torch.tanh(c)
        return h @ self.fc_w[0] + self.fc_b[0]

    def step(self, thrust, throttle, dt):
        """One 1 kHz step: (T[..., N], u[..., N]) -> (T_next, Ṫ) in Newtons.

        Broadcasts over leading dimensions (lanes, jets).
        """
        t_n = (thrust - self.thrust_mean) / self.thrust_std
        u_n = (throttle - self.throttle_mean) / self.throttle_std
        x = torch.stack([t_n, u_n], dim=-1)
        td_n = self._cell(x)
        t_next_n = t_n + td_n * dt
        return (t_next_n * self.thrust_std + self.thrust_mean,
                td_n * self.thrust_std)
