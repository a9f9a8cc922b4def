"""The one generator of every traffic mix: recorded plant streams replayed
in passes, each lane's momentum perturbed from the seed.

A traffic file (``mpcbench/traffic/<name>.json``) holds:

- ``lanes``: controllers solved together, one batch;
- ``decisions``: ``per_lane`` (each lane's solver decides alone; no host
  read-back) or ``batch_wide`` (one decision for the batch, read on the
  host);
- ``streams``: the recorded streams replayed, in turn, one pass each
  (``mpcbench/streams/<name>.npz``);
- ``commands_to_host``: ``every_tick`` (each tick ends when its joint
  references and throttle are on the host: the robot's loop) or
  ``every_pass`` (the device is synchronised once at the end of a pass);
- ``warm_passes``: passes of each stream run in set-up;
- ``check_lanes``: how many lanes, drawn from the seed, the reference
  checks (every lane where there are no more);
- ``check_ticks``: how many of each checked lane's ticks of each stream in
  the window, drawn from the seed, it checks step by step, or ``"all"``
  (all where there are no more).

Keys every mix so far shares take the value of :data:`DEFAULTS` where the
file leaves them out; a later mix that needs another value states it:

- ``lead_in``: the first ticks of each stream, run once in set-up; every
  pass starts from the carry they leave, restored by a device copy, and
  replays the stream's remaining ticks (``PERF.md`` §7: from
  ``configure``'s carry the streams' first tick does not converge);
- ``momentum_sigma``: σ of the momentum perturbation σ·N(0, 1) [lanes,
  6], drawn once a run from ``--seed`` and added on every tick of every
  pass;
- ``trace_ticks``: ticks of each stream in the ``--trace 1`` window.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

KEYS = ("lanes", "decisions", "streams", "commands_to_host", "warm_passes",
        "check_lanes", "check_ticks")
DEFAULTS = dict(lead_in=1, momentum_sigma=0.1, trace_ticks=40)


class Draw(NamedTuple):
    jitter: np.ndarray        # [lanes, 6] float32
    check_lanes: np.ndarray   # sorted lane indices the reference checks
    ticks: np.random.Generator  # draws the checked ticks after the window


def load(path) -> dict:
    traffic = {**DEFAULTS, **json.loads(Path(path).read_text())}
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    if traffic["decisions"] not in ("per_lane", "batch_wide"):
        raise ValueError(f"{path}: decisions {traffic['decisions']!r}")
    if traffic["commands_to_host"] not in ("every_tick", "every_pass"):
        raise ValueError(f"{path}: commands_to_host "
                         f"{traffic['commands_to_host']!r}")
    if traffic["check_ticks"] != "all" and not isinstance(
            traffic["check_ticks"], int):
        raise ValueError(f"{path}: check_ticks {traffic['check_ticks']!r}")
    return traffic


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
