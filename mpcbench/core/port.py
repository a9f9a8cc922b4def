"""What the benchmark takes from the program: its configuration types, its
MPC tick and its counters. With the loops (``mpcbench/loops/*.py``) the
only modules of the harness that import ``ironcub_mpc_tpu_torch``, and only
inside functions; a loop takes what this module gives and imports any more
of the program it drives itself.

- :func:`build` turns a configuration file and a traffic mix into the
  port's ``MPCConfig``, horizon schedule, joint selector and
  ``ADMMSettings``;
- :func:`load_stream` reads a stream file into the port's ``RobotSnapshot``
  on the device (the benchmark's own reader: it does not go through
  ``runtime/replay.py``);
- :func:`configure` and :func:`tick` call the port's ``qp/mpc.py``;
- :func:`build_kernels` builds the kernels a loop names, and :func:`load`
  imports the program alone;
- :func:`counters` reads every counter the program keeps (its kernel
  wrappers' launches, its batch-wide decisions' host read-backs, and any
  later one kept the same way), and :func:`instrument` wraps every
  counted function for a traced run, found by its counter, not by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
from typing import NamedTuple

import numpy as np
import torch

PACKAGE = "ironcub_mpc_tpu_torch"
CHANNELS = ("positionCoM", "velocityCoM", "RPY", "RPYDot")


class Stream(NamedTuple):
    snaps: object                  # RobotSnapshot, tensors [T+1, ...] f32
    est_td: torch.Tensor           # [T, 4]
    channels: dict                 # reference windows (numpy f32)
    alpha: np.ndarray              # alphaGravity slice (numpy f32)
    initial_throttle: torch.Tensor  # [4]

    @property
    def n_ticks(self) -> int:
        return int(self.est_td.shape[0])


class Controller(NamedTuple):
    cfg: object
    sched: object
    sel: tuple
    settings: object


def load() -> None:
    """Import the program: its import pins PyTorch's float32 products to
    full precision (TF32 off), which a control that lowers them follows."""
    import ironcub_mpc_tpu_torch  # noqa: F401


def build(config: dict, traffic: dict) -> Controller:
    from ironcub_mpc_tpu_torch.core.config import (MPCConfig, RobotConfig,
                                                   joint_selector)
    from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
    from ironcub_mpc_tpu_torch.ops import admm

    mpc = {k: tuple(v) if isinstance(v, list) else v
           for k, v in config["mpc"].items()}
    cfg = dataclasses.replace(MPCConfig(), **mpc)
    robot = RobotConfig(axes_list=tuple(config["robot"]["axes_list"]))
    solver = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["solver"].items()}
    settings = admm.ADMMSettings(
        **solver, batch_guard=traffic["decisions"] == "batch_wide")
    return Controller(cfg, build_schedule(cfg), joint_selector(robot, cfg),
                      settings)


def load_stream(path, device) -> Stream:
    from ironcub_mpc_tpu_torch.core.types import RobotSnapshot

    npz = np.load(path)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Stream(
        snaps=RobotSnapshot(**{f: f32(npz[f"snap_{f}"])
                               for f in RobotSnapshot._fields}),
        est_td=f32(npz["est_td"]),
        channels={k: np.asarray(npz[f"ch_{k}"]) for k in CHANNELS},
        alpha=np.asarray(npz["alpha"]),
        initial_throttle=f32(npz["initial_throttle"]))


def snapshot(stream: Stream, t: int, lanes: int, jitter: torch.Tensor):
    """Tick ``t``'s inputs for ``lanes`` lanes: frame t+1 with ``jitter``
    [lanes, 6] added to the momentum, and est_td[t]."""
    snaps = stream.snaps
    snap = type(snaps)(*(a[t + 1].expand(lanes, *a.shape[1:])
                         for a in snaps))
    snap = snap._replace(momentum_body=snap.momentum_body + jitter)
    return snap, stream.est_td[t].expand(lanes, 4)


def configure(ctl: Controller, stream: Stream, lanes: int, device):
    """(problem, carry of ``lanes`` lanes) configured from frame 0."""
    from ironcub_mpc_tpu_torch.core.types import expand_lanes
    from ironcub_mpc_tpu_torch.qp import mpc

    snap0 = type(stream.snaps)(*(a[0:1] for a in stream.snaps))
    problem, carry = mpc.configure(
        ctl.cfg, ctl.sched, ctl.sel, snap0, stream.channels, stream.alpha,
        ctl.settings, initial_throttle=stream.initial_throttle, device=device)
    return problem, expand_lanes(carry, lanes)


def tick(ctl: Controller, problem, carry, snap, est):
    from ironcub_mpc_tpu_torch.qp import mpc

    return mpc.mpc_tick(ctl.cfg, ctl.sched, ctl.sel, ctl.settings, problem,
                        carry, snap, est)


def clone(carry):
    """A device copy of every tensor of a carry."""
    from ironcub_mpc_tpu_torch.core.types import tree_map

    return tree_map(torch.clone, carry)


def _counted(attr: str) -> list:
    """(module, name, function) of every function of the port's loaded
    modules that keeps the integer counter ``attr``: a kernel wrapper's
    ``launches``, a batch-wide decision's ``syncs``."""
    out = []
    for mname, mod in list(sys.modules.items()):
        if mod is None or mname.split(".")[0] != PACKAGE:
            continue
        for fname, f in list(vars(mod).items()):
            if (callable(f) and getattr(f, "__module__", None) == mname
                    and type(getattr(f, attr, None)) is int):
                out.append((mod, fname, f))
    return out


def counters() -> dict:
    """Every counter the program keeps: each integer attribute of each
    function of the port's loaded modules, keyed ``<module below the
    package>.<function>.<attribute>`` (``qp.condensed.batch_any.syncs``,
    ``ops.kernels.woodbury_ns.launches``)."""
    out = {}
    for mname, mod in list(sys.modules.items()):
        if mod is None or mname.split(".")[0] != PACKAGE:
            continue
        short = mname[len(PACKAGE) + 1:]
        for fname, f in list(vars(mod).items()):
            if not callable(f) or getattr(f, "__module__", None) != mname:
                continue
            for attr, v in list(getattr(f, "__dict__", {}).items()):
                if type(v) is int:
                    out[f"{short}.{fname}.{attr}"] = v
    return out


def build_kernels(names) -> None:
    """Compile the program's kernels ``names``, where not built yet."""
    from ironcub_mpc_tpu_torch.ops import kernels

    kernels.build(names)


@contextlib.contextmanager
def wrapped(attr: str, make):
    """Within the block every function of the port that keeps the counter
    ``attr`` is replaced in its module by ``make(name, function)``. An
    original that counts through its module's global name counts on the
    wrapper meanwhile: the wrapper starts from its counts and hands what it
    counted back on the way out. Yields the names replaced."""
    from ironcub_mpc_tpu_torch.qp import mpc  # noqa: F401  (the tick's modules)

    swaps = []
    for mod, name, f in _counted(attr):
        w = functools.wraps(f)(make(name, f))
        setattr(mod, name, w)
        swaps.append((mod, name, f, w, {k: v for k, v in vars(w).items()
                                        if type(v) is int}))
    try:
        yield [name for _, name, _, _, _ in swaps]
    finally:
        for mod, name, f, w, start in swaps:
            for k, v in start.items():
                setattr(f, k, getattr(f, k) + getattr(w, k) - v)
            setattr(mod, name, f)


def _arguments(args, kwargs) -> dict:
    """A call's arguments as a roofline count reads them: the shapes of its
    positional tensors in order under ``shapes``, each keyword by its name
    (a tensor's shape, a number as it is)."""
    rec = dict(shapes=[tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor)])
    for k, v in kwargs.items():
        if isinstance(v, torch.Tensor):
            rec[k] = tuple(v.shape)
        elif isinstance(v, (bool, int, float)) or v is None:
            rec[k] = v
    return rec


@contextlib.contextmanager
def instrument(calls: dict):
    """Within the block every kernel wrapper (a function that counts its
    ``launches``) appends each call's arguments (:func:`_arguments`) to
    ``calls[<wrapper>]``, and every batch-wide decision (a function that
    counts its host read-backs, ``syncs``) runs inside a profiler span of
    its own name. Yields those spans' names. The counters keep counting."""

    def kernel(name, f):
        def call(*args, **kwargs):
            calls.setdefault(name, []).append(_arguments(args, kwargs))
            return f(*args, **kwargs)
        return call

    def decision(name, f):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return f(*args, **kwargs)
        return call

    with wrapped("launches", kernel), wrapped("syncs", decision) as spans:
        yield spans
