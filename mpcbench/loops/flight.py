"""The flight loop: the paper's simulated flight, the MPC closed every 5 ms
over the port's 1 kHz plant with LSTM+EKF jets, in passes from recorded
mid-mission states.

A flight mix (``mpcbench/traffic/<name>.json``, ``"loop": "flight"``)
holds, besides the keys every mix has (``core/traffic.py``):

- ``decisions``: ``per_lane`` or ``batch_wide``, as the replay's;
- ``start``: the recorded settled state the controller is configured from
  at mission start (``mpcbench/streams/<start>.npz``);
- ``starts``: the recorded mid-mission states (plant state and controller
  carry) the passes start from, in turn, one pass each;
- ``ticks``: ticks a pass, each one ``ClosedLoop.tick`` (the snapshot, an
  ``mpc_tick``, the commands applied, the plant's substeps);
- ``wind_sigma_N``: σ of the constant world-frame wind force at the base,
  drawn a start, a lane and an axis from ``--seed`` and held for every
  pass from that start;
- ``warm_passes``: passes of each start run in set-up;
- ``check_lanes``: how many lanes, drawn from the seed, the reference
  checks (every lane where there are no more);
- ``check_ticks``: the ticks of each pass in the window the reference
  checks step by step, ``"all"`` or a number drawn from the seed;
- ``chain_ticks``: the first ticks of the first pass from each start in
  the window that the reference flies as its own closed loop.

The deployment flies one robot (``lanes`` 1); more lanes fly the same
mission side by side from the same starts, each under its own wind, the
controller configured once for all of them (``runtime/loop.py``).

``tools/make_flight_starts.py`` writes the states; their recorded carries
start warm, so a pass needs no lead-in tick. Set-up builds the flight loop
through ``runtime/flight.py``'s ``build_flight_loop`` from the
configuration's ``mpc``, ``solver``, ``plant`` and ``sim`` (and checks
that its data files are those the program loads), builds the two kernels
the MPC tick launches, configures the controller on the settled state,
restores each start by ``runtime/checkpoint.py`` onto the device with the
lanes' winds set in its ``wind_force``, and warms up with ``warm_passes``
passes of each start. Sensor noise is off in the configuration, so no
pass draws from the plant's noise generator. A pass restores its start by
device copies and runs its ticks, the MPC step of each going through the
harness's adapter (``core/port.py`` ``tick``); each tick ends with one row
a checked lane on the host where the mix sends commands every tick: the
commands (joint references, throttle, thrust, thrust rate), the snapshot's
CoM and body momentum, and the plant state after the tick
(:data:`COLUMNS`).

The check (``mpcbench/reference/flight.py``, float64, nothing of the
program) follows each pass tick by tick from the program's plant state and
its commands of the tick before, and flies its own closed loop over the
first ``chain_ticks`` of each start; the candidate numbers are the largest
gaps (:data:`NUMBERS`), ``chain_`` before those of the chained loop.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from mpcbench.core import driver, port, spec
from mpcbench.reference import flight as reference

KEYS = ("decisions", "start", "starts", "ticks", "wind_sigma_N",
        "warm_passes", "check_lanes", "check_ticks", "chain_ticks")
KERNELS = ("admm_segment", "woodbury_ns")
WORKERS = 4
CHUNK = 100   # checked ticks a reference task (each replays its prefix)

WIDTHS = dict(joints_pos_ref=23, throttle=4, thrust_des=4, thrust_dot_des=4,
              com=3, momentum=6, base_R=9, base_p=3, base_v=6, q=23, qd=23,
              thrust_nn=4, ekf_x=8, ekf_P=16, q_des=23)
# the throttle the plant holds after a tick is the tick's own command
ROW = ("joints_pos_ref", "throttle", "thrust_des", "thrust_dot_des", "com",
       "momentum", "base_R", "base_p", "base_v", "q", "qd", "thrust_nn",
       "ekf_x", "ekf_P", "q_des")


def _columns() -> dict:
    out, at = {}, 0
    for k in ROW:
        out[k] = slice(at, at + WIDTHS[k])
        at += WIDTHS[k]
    return out


COLUMNS = _columns()
# candidate number: (part of the reference's output, field, columns of it)
NUMBERS = {
    "snap_com_m": ("observed", "com", slice(None)),
    "snap_momentum": ("observed", "momentum", slice(None)),
    "joints_rad": ("commands", "joints_pos_ref", slice(None)),
    "throttle_pct": ("commands", "throttle", slice(None)),
    "thrust_N": ("commands", "thrust_des", slice(None)),
    "thrust_rate_Nps": ("commands", "thrust_dot_des", slice(None)),
    "next_base_pos_m": ("next", "base_p", slice(None)),
    "next_base_rot": ("next", "base_R", slice(None)),
    "next_joints_rad": ("next", "q", slice(None)),
    "next_nu": ("next", "nu", slice(None)),
    "next_thrust_lstm_N": ("next", "thrust_nn", slice(None)),
    "next_ekf_thrust_N": ("next", "ekf_x", slice(0, None, 2)),
    "next_ekf_thrust_rate_Nps": ("next", "ekf_x", slice(1, None, 2)),
}


def validate(traffic: dict, path) -> None:
    if traffic["decisions"] not in ("per_lane", "batch_wide"):
        raise ValueError(f"{path}: decisions {traffic['decisions']!r}")
    if traffic["check_ticks"] != "all" and not isinstance(
            traffic["check_ticks"], int):
        raise ValueError(f"{path}: check_ticks {traffic['check_ticks']!r}")


class Draw(NamedTuple):
    wind: dict                  # {start: [lanes, 3]}, newtons, world frame
    check_lanes: np.ndarray     # sorted lane indices the reference checks
    ticks: np.random.Generator  # draws the checked ticks after the window


def draw(traffic: dict, seed: int) -> Draw:
    """The seed's winds and checked lanes. Every seed does the same work:
    the same ticks and passes; only the wind and the checked sample
    move."""
    seq = np.random.SeedSequence(abs(int(seed)))
    wind_rng, lane_rng, tick_rng = (np.random.default_rng(s)
                                    for s in seq.spawn(3))
    lanes, sigma = int(traffic["lanes"]), float(traffic["wind_sigma_N"])
    wind = {s: sigma * wind_rng.standard_normal((lanes, 3))
            for s in traffic["starts"]}
    k = min(int(traffic["check_lanes"]), lanes)
    return Draw(wind, np.sort(lane_rng.choice(lanes, size=k, replace=False)),
                tick_rng)


def _arrays(z, prefix: str) -> dict:
    return {k: torch.as_tensor(z[k]) for k in z.files
            if k.startswith(prefix + ".")}


def _data_files(config: dict) -> None:
    """Refuse a configuration whose data files are not those the
    program's flight loads."""
    from ironcub_mpc_tpu_torch.dynamics import ironcub_model
    from ironcub_mpc_tpu_torch.runtime import flight

    named = {config["model"]["urdf"]: ironcub_model.CALIBRATED_URDF,
             config["model"]["lstm_weights"]:
                 flight.ROOT / "data/jet_lstm_weights.npz",
             config["mpc"]["position_trajectory"]:
                 flight.ROOT / "data/trajectories/minimum_jerk.npz",
             config["mpc"]["alpha_gravity_trajectory"]:
                 flight.ROOT / "data/trajectories/alpha_gravity.npz"}
    for rel, used in named.items():
        if (spec.ROOT / rel).resolve() != Path(used).resolve():
            raise ValueError(f"the configuration names {rel}; the program "
                             f"loads {used}")


def row(commands: dict, com, momentum, p) -> torch.Tensor:
    """[lanes, 163] rows of :data:`COLUMNS`: ``commands`` (joint
    references, throttle, thrust, thrust rate), the snapshot's CoM and body
    momentum, the plant state ``p``."""
    parts = dict(commands, com=com, momentum=momentum, base_R=p.base_R,
                 base_p=p.base_p, base_v=p.base_v, q=p.q, qd=p.qd,
                 thrust_nn=p.thrust_nn, ekf_x=p.ekf.x, ekf_P=p.ekf.P,
                 q_des=p.q_des)
    return torch.cat([parts[k].flatten(1) for k in ROW], 1)


def start_row(carry) -> np.ndarray:
    """A recorded start of one lane as a row (host, float64): the carry's
    commands, no snapshot, the start's plant state."""
    m, p = carry.mpc, carry.plant
    r = row(dict(joints_pos_ref=m.joints_pos_ref, throttle=m.throttle_cmd,
                 thrust_des=m.thrust_des, thrust_dot_des=m.thrust_dot_des),
            torch.zeros_like(p.base_p), torch.zeros_like(p.base_v), p)
    return r[0].cpu().numpy().astype(np.float64)


class Loop:
    """The flight after set-up: the closed loop, its problem, each start
    restored on the device, and the seed's draw."""

    def __init__(self, cell, seed):
        from ironcub_mpc_tpu_torch.core.config import SimConfig
        from ironcub_mpc_tpu_torch.core.types import expand_lanes, tree_map
        from ironcub_mpc_tpu_torch.runtime import checkpoint, flight
        from ironcub_mpc_tpu_torch.sim.plant import PlantParams

        self.traffic = traffic = cell.traffic
        self.config_path = cell.config_path
        self.dev = cell.dev
        self.per_tick = cell.per_tick
        config = cell.config
        ctl = port.build(config, traffic)
        sim = SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["sim"].items()})
        self.loop, pos_traj, alpha_traj = flight.build_flight_loop(
            device=self.dev, mpc_cfg=ctl.cfg, settings=ctl.settings,
            plant_params=PlantParams(**config["plant"]), sim_cfg=sim)
        _data_files(config)

        def mpc_step(cfg, sched, sel, settings, problem, carry, snap, est):
            return port.tick(ctl, problem, carry, snap, est)

        self.loop.mpc_tick = mpc_step
        if self.dev.type == "cuda":
            port.build_kernels(KERNELS)
        self.draw = draw(traffic, seed)
        self.check_idx = torch.as_tensor(self.draw.check_lanes,
                                         device=self.dev)
        self.every_lane = len(self.draw.check_lanes) == cell.lanes
        z = np.load(spec.stream_path(traffic["start"]))
        settled = checkpoint.unflatten(
            _arrays(z, "plant"), "plant",
            flight.standing_state(self.loop.plant, sim.initial_position_deg))
        self.problem, carry0 = self.loop.configure(
            expand_lanes(settled, cell.lanes),
            *flight.mission_inputs(pos_traj, alpha_traj))
        one = tree_map(lambda t: t[:1], carry0)
        self.starts, self.start_rows = {}, {}
        for s in traffic["starts"]:
            carry = checkpoint.unflatten(
                _arrays(np.load(spec.stream_path(s)), "carry"), "carry", one)
            self.start_rows[s] = start_row(carry)
            carry = expand_lanes(carry, cell.lanes)
            wind = torch.as_tensor(self.draw.wind[s],
                                   dtype=carry.plant.base_p.dtype,
                                   device=self.dev)
            self.starts[s] = carry._replace(
                plant=carry.plant._replace(wind_force=wind))
        self.passes = list(traffic["starts"])
        self.lead_in_status = {}
        for _ in range(int(traffic["warm_passes"])):
            for s in self.passes:
                self.run_pass(s, [], [])
        driver.sync(self.dev)

    def run_pass(self, s, records, statuses, n_ticks=None, latencies=None,
                 deadline=None, span=None):
        """One pass from start ``s`` (its first ``n_ticks`` ticks). Returns
        False when a tick crossed ``deadline``."""
        span = span or driver.NOSPAN
        carry = port.clone(self.starts[s])
        ticks = int(self.traffic["ticks"])
        n = ticks if n_ticks is None else min(n_ticks, ticks)
        for t in range(n):
            t1 = time.perf_counter()
            with span("mpc_tick"):
                carry, tel = self.loop.tick(self.problem, carry)
            with span("commands"):
                rows = row(dict(joints_pos_ref=tel.joints_pos_ref,
                                throttle=tel.throttle,
                                thrust_des=tel.thrust_desired,
                                thrust_dot_des=tel.thrust_desired_dot),
                           tel.com_position,
                           torch.cat((tel.linear_momentum,
                                      tel.angular_momentum), 1),
                           carry.plant)
                if not self.every_lane:
                    rows = rows.index_select(0, self.check_idx)
                if self.per_tick:
                    rows = rows.cpu()
            t2 = time.perf_counter()
            records.append((s, t, rows))
            statuses.append(tel.solver_status)
            if latencies is not None:
                latencies.append(t2 - t1)
            if deadline is not None and self.per_tick and t2 >= deadline:
                return False
        if not self.per_tick:
            with span("pass_sync"):
                driver.sync(self.dev)
        return True

    def check(self, records, statuses, detail=None) -> dict:
        """The candidate numbers of a window's records, once the program's
        state is freed."""
        host = [(s, t, np.asarray(
            r.cpu().numpy() if isinstance(r, torch.Tensor) else r,
            np.float64)) for s, t, r in records]
        records.clear()
        statuses.clear()
        self.starts.clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        runs = passes(host)
        steps, chained = self._references(host, runs)
        numbers = compare(host, steps, runs, chained)
        numbers["nonfinite"] = int(sum((~np.isfinite(r)).sum()
                                       for _, _, r in host))
        if detail is not None:
            detail.update(numbers=numbers, cases=len(steps),
                          chained=sum(len(v) for v in chained.values()))
        return numbers

    def _references(self, host, runs):
        """The reference's outputs in a few worker processes: step by step
        {(record index, lane position): output} over the checked ticks of
        every pass and checked lane, and chained {(start, lane position):
        [output a tick]} over the first pass of each start, up to
        ``chain_ticks``."""
        tr = self.traffic
        config = str(self.config_path)
        start = str(spec.stream_path(tr["start"]))
        tasks = []
        for s, idx in runs:
            picked = _picked(len(idx), tr["check_ticks"], self.draw.ticks)
            for pos, lane in enumerate(self.draw.check_lanes):
                entries = []
                for j, i in enumerate(idx):
                    before = (self.start_rows[s] if j == 0
                              else host[idx[j - 1]][2][pos])
                    entries.append((_state(before), _commands(before),
                                    _commands(host[i][2][pos])))
                for at in range(0, len(picked), CHUNK):
                    chunk = picked[at:at + CHUNK]
                    todo = [(k in chunk, *entries[k])
                            for k in range(chunk[-1] + 1)]
                    tasks.append(("step", [(idx[k], pos) for k in chunk],
                                  reference.step_pass_task,
                                  (config, start, str(spec.stream_path(s)),
                                   self.draw.wind[s][lane], todo)))
        for s, idx in first_passes(runs).items():
            n = min(int(tr["chain_ticks"]), len(idx))
            for pos, lane in enumerate(self.draw.check_lanes):
                tasks.append(("chain", (s, pos), reference.chain_pass_task,
                              (config, start, str(spec.stream_path(s)),
                               self.draw.wind[s][lane], n)))
        steps, chained = {}, {}
        if not tasks:
            return steps, chained
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ[var] = "1"
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(WORKERS, len(tasks)),
                                 mp_context=ctx) as pool:
            futures = [(kind, key, pool.submit(fn, args))
                       for kind, key, fn, args in tasks]
            for kind, key, fut in futures:
                if kind == "step":
                    steps.update(zip(key, fut.result()))
                else:
                    chained[key] = fut.result()
        return steps, chained


def passes(host) -> list:
    """[(start, [record index])] of every pass in the window, in order: a
    pass's records lie together, from its tick 0 (the last one may stop
    short)."""
    out = []
    for i, (s, t, _) in enumerate(host):
        if t == 0:
            out.append((s, [i]))
        else:
            out[-1][1].append(i)
    return out


def first_passes(runs) -> dict:
    """{start: [record index]} of the first pass from each start."""
    first = {}
    for s, idx in runs:
        first.setdefault(s, idx)
    return first


def _picked(n: int, per_pass, rng) -> list:
    """The ticks of a pass of ``n`` the reference checks step by step."""
    if per_pass == "all" or n <= per_pass:
        return list(range(n))
    return sorted(int(j) for j in rng.choice(n, size=per_pass,
                                             replace=False))


def _state(row) -> dict:
    """A row's plant state, the reference's fields."""
    c = COLUMNS
    return dict(base_R=row[c["base_R"]].reshape(3, 3), base_p=row[c["base_p"]],
                base_v=row[c["base_v"]], q=row[c["q"]], qd=row[c["qd"]],
                thrust_nn=row[c["thrust_nn"]],
                ekf_x=row[c["ekf_x"]].reshape(4, 2),
                ekf_P=row[c["ekf_P"]].reshape(4, 2, 2),
                throttle=row[c["throttle"]], q_des=row[c["q_des"]])


def _commands(row) -> dict:
    return {k: row[COLUMNS[k]] for k in reference.COMMANDS}


def _fields(row) -> dict:
    """A row as the reference's output: observed, commands, next."""
    st = _state(row)
    st["nu"] = np.concatenate([st["base_v"], st["qd"]])
    return dict(observed=dict(com=row[COLUMNS["com"]],
                              momentum=row[COLUMNS["momentum"]]),
                commands=_commands(row), next=st)


def _widest(worst: dict, prefix: str, got: dict, ref: dict) -> None:
    ref = dict(ref, next=dict(ref["next"], nu=np.concatenate(
        [ref["next"]["base_v"], ref["next"]["qd"]])))
    for name, (part, field, cols) in NUMBERS.items():
        a = np.asarray(got[part][field], np.float64).reshape(-1)[cols]
        b = np.asarray(ref[part][field], np.float64).reshape(-1)[cols]
        gap = np.abs(a - b)[np.isfinite(a)]
        if gap.size:
            worst[prefix + name] = max(worst[prefix + name], float(gap.max()))


def compare(host, steps: dict, runs, chained: dict) -> dict:
    """Every candidate number over the checked ticks and lanes and the
    chained passes."""
    worst = {p + name: 0.0 for p in ("", "chain_") for name in NUMBERS}
    for (i, pos), ref in steps.items():
        _widest(worst, "", _fields(host[i][2][pos]), ref)
    first = first_passes(runs)
    for (s, pos), refs in chained.items():
        for i, ref in zip(first[s], refs):
            _widest(worst, "chain_", _fields(host[i][2][pos]), ref)
    return worst
