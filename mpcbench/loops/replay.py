"""The replay loop: recorded plant streams replayed open loop, in passes,
each lane's momentum perturbed from the seed, every tick one ``mpc_tick``.

A replay mix (``mpcbench/traffic/<name>.json``) holds, besides the keys
every mix has (``core/traffic.py``):

- ``decisions``: ``per_lane`` (each lane's solver decides alone; no host
  read-back) or ``batch_wide`` (one decision for the batch, read on the
  host);
- ``streams``: the recorded streams replayed, in turn, one pass each
  (``mpcbench/streams/<name>.npz``);
- ``warm_passes``: passes of each stream run in set-up;
- ``check_lanes``: how many lanes, drawn from the seed, the reference
  checks (every lane where there are no more);
- ``check_ticks``: how many of each checked lane's ticks of each stream in
  the window, drawn from the seed, it checks step by step, or ``"all"``
  (all where there are no more).

Keys every replay mix so far shares take the value of :data:`DEFAULTS`
where the file leaves them out; a later mix that needs another value
states it:

- ``lead_in``: the first ticks of each stream, run once in set-up; every
  pass starts from the carry they leave, restored by a device copy, and
  replays the stream's remaining ticks (``PERF.md`` §7: from
  ``configure``'s carry the streams' first tick does not converge);
- ``momentum_sigma``: σ of the momentum perturbation σ·N(0, 1) [lanes,
  6], drawn once a run from ``--seed`` and added on every tick of every
  pass.

Set-up builds the two kernels the replay launches (``build/torch_kernels/``
inside the checkout, the port's own fixed cache), loads each stream of the
mix onto the device, configures the controller from the stream's frame 0,
runs the stream's lead-in ticks, makes every pass tick's inputs, and warms
up with ``warm_passes`` passes of each stream through the window's own
loop. A pass is a stream: its carry restored, then its ticks, each ending
with its checked lanes' commands (joint references, throttle, thrust,
thrust rate, the terminal predicted state) on the host where the mix sends
commands every tick. The check holds them against the float64 reference
(``core/check.py``, ``reference/chain.py``).

Every seed gives the same sizes, ticks and passes; only the perturbation
and the checked sample move.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from mpcbench.core import check, driver, port, spec

KEYS = ("decisions", "streams", "warm_passes", "check_lanes", "check_ticks")
DEFAULTS = dict(lead_in=1, momentum_sigma=0.1)
KERNELS = ("admm_segment", "woodbury_ns")


def validate(traffic: dict, path) -> None:
    if traffic["decisions"] not in ("per_lane", "batch_wide"):
        raise ValueError(f"{path}: decisions {traffic['decisions']!r}")
    if traffic["check_ticks"] != "all" and not isinstance(
            traffic["check_ticks"], int):
        raise ValueError(f"{path}: check_ticks {traffic['check_ticks']!r}")


class Draw(NamedTuple):
    jitter: np.ndarray        # [lanes, 6] float32
    check_lanes: np.ndarray   # sorted lane indices the reference checks
    ticks: np.random.Generator  # draws the checked ticks after the window


def draw(traffic: dict, seed: int) -> Draw:
    """The seed's perturbation and checked lanes. Every seed gives the same
    sizes, ticks and passes; only the perturbation and the sample move."""
    seq = np.random.SeedSequence(abs(int(seed)))
    jit_rng, lane_rng, tick_rng = (np.random.default_rng(s)
                                   for s in seq.spawn(3))
    lanes = int(traffic["lanes"])
    jitter = (traffic["momentum_sigma"]
              * jit_rng.standard_normal((lanes, 6))).astype(np.float32)
    k = min(int(traffic["check_lanes"]), lanes)
    sample = np.sort(lane_rng.choice(lanes, size=k, replace=False))
    return Draw(jitter, sample, tick_rng)


def pass_ticks(traffic: dict, n_ticks: int) -> range:
    """The stream ticks a pass replays."""
    return range(int(traffic["lead_in"]), n_ticks)


class Loop:
    """The replay after set-up: the controller, each stream's problem,
    lead-in carry and pass inputs, and the seed's draw."""

    def __init__(self, cell, seed):
        self.traffic = cell.traffic
        self.config_path = cell.config_path
        self.dev = cell.dev
        self.ctl = port.build(cell.config, self.traffic)
        self.draw = draw(self.traffic, seed)
        self.lanes = cell.lanes
        self.lead_in = int(self.traffic["lead_in"])
        self.per_tick = cell.per_tick
        self.check_idx = torch.as_tensor(self.draw.check_lanes,
                                         device=self.dev)
        self.every_lane = len(self.draw.check_lanes) == self.lanes
        if self.dev.type == "cuda":
            port.build_kernels(KERNELS)
        jitter = torch.as_tensor(self.draw.jitter, device=self.dev)
        self.streams = {}
        self.start = {}
        self.lead_in_status = {}
        for s in self.traffic["streams"]:
            st = port.load_stream(spec.stream_path(s), self.dev)
            problem, carry = port.configure(self.ctl, st, self.lanes,
                                            self.dev)
            rows = None
            for t in range(self.lead_in):
                carry, out = port.tick(self.ctl, problem, carry,
                                       *port.snapshot(st, t, self.lanes,
                                                      jitter))
                rows = self._rows(out)
                self.lead_in_status.setdefault(s, []).append(out.status)
            self.start[s] = None if rows is None else np.asarray(
                rows.cpu().numpy(), np.float64)
            ticks = pass_ticks(self.traffic, st.n_ticks)
            inputs = [port.snapshot(st, t, self.lanes, jitter) for t in ticks]
            self.streams[s] = (problem, carry, list(ticks), inputs)
        self.passes = list(self.streams)
        for _ in range(int(self.traffic["warm_passes"])):
            for s in self.passes:
                self.run_pass(s, [], [])
        driver.sync(self.dev)

    def _rows(self, out):
        """The checked lanes' outputs of a tick, [checked lanes, 61]: the
        commands and the terminal predicted state."""
        rows = torch.cat((out.joints_pos_ref, out.throttle, out.thrust_des,
                          out.thrust_dot_des, out.final_state), dim=1)
        return rows if self.every_lane else rows.index_select(
            0, self.check_idx)

    def run_pass(self, s, records, statuses, n_ticks=None, latencies=None,
                 deadline=None, span=None):
        """One pass of stream ``s`` (its first ``n_ticks`` ticks). Returns
        False when a tick crossed ``deadline``."""
        span = span or driver.NOSPAN
        problem, saved, ticks, inputs = self.streams[s]
        carry = port.clone(saved)
        n = len(ticks) if n_ticks is None else min(n_ticks, len(ticks))
        for t, (snap, est) in zip(ticks[:n], inputs[:n]):
            t1 = time.perf_counter()
            with span("mpc_tick"):
                carry, out = port.tick(self.ctl, problem, carry, snap, est)
            with span("commands"):
                rows = self._rows(out)
                if self.per_tick:
                    rows = rows.cpu()
            t2 = time.perf_counter()
            records.append((s, t, rows))
            statuses.append(out.status)
            if latencies is not None:
                latencies.append(t2 - t1)
            if deadline is not None and self.per_tick and t2 >= deadline:
                return False
        if not self.per_tick:
            with span("pass_sync"):
                driver.sync(self.dev)
        return True

    def check(self, records, statuses, detail=None) -> dict:
        """The candidate numbers of a window's records (``core/check.py``),
        once the streams are freed."""
        host = [(s, t, r.cpu().numpy() if isinstance(r, torch.Tensor) else r)
                for s, t, r in records]
        records.clear()
        statuses.clear()
        self.streams.clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        todo = check.cases(host, self.start, self.lead_in,
                           len(self.draw.check_lanes), self.draw.ticks,
                           self.traffic["check_ticks"])
        passes = check.first_passes(host, self.lead_in)
        steps, chained = check.references(
            self.config_path, spec.stream_path,
            self.draw.jitter[self.draw.check_lanes], todo, passes,
            self.start, self.lead_in)
        numbers = check.compare(host, todo, steps, passes, chained)
        if detail is not None:
            detail.update(numbers=numbers,
                          cases=sum(len(c) for c in todo.values()),
                          chained=sum(len(r) for r in passes.values()))
        return numbers
