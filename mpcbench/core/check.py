"""The correctness check: the program's outputs against the float64
reference, lane-tick by lane-tick, after the window.

For each checked lane and each checked tick, the reference
(``mpcbench/reference/chain.py`` ``step_lane``) starts from the commands
the program gave on the tick before (at a pass's first tick, from the
lead-in's) and from its own update of the controller's state, solves the
tick's QP exactly in float64, and the program's outputs are held against
it. The candidate numbers, each the largest gap over every checked
lane-tick:

- ``joints_rad``: joint position references [rad] (the tick's joint step
  and its integration);
- ``throttle_pct``: throttle [%];
- ``thrust_N``, ``thrust_rate_Nps``: thrust and its rate at knot 1;
- ``final_<group>``: the terminal predicted state F u + f by groups
  (``com_m``, ``linmom``, ``rpy_rad``, ``angmom``, ``thrust_N``,
  ``thrust_rate_Nps``, ``err``);
- ``nonfinite``: checked outputs that are not finite;
- ``chain_<group>`` (the command groups and ``final_err``): the same gaps
  against the reference chained on its own exact solutions
  (``run_lane``) over the first pass of each stream in the window, from
  the lead-in's commands, for every checked lane. Step by step the
  reference reads the program's commands of the tick before, so a small
  error that the program repeats tick after tick passes each step and
  adds up over a pass: the chain sees the sum.

A cell compares the numbers its file ``mpcbench/cells/<workload>.json``
gives limits for; ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..reference import chain

COLS = chain.columns()
GROUPS = {"joints_rad": ("joints_pos_ref", slice(None)),
          "throttle_pct": ("throttle", slice(None)),
          "thrust_N": ("thrust_des", slice(None)),
          "thrust_rate_Nps": ("thrust_dot_des", slice(None)),
          "final_com_m": ("final_state", slice(0, 3)),
          "final_linmom": ("final_state", slice(3, 6)),
          "final_rpy_rad": ("final_state", slice(6, 9)),
          "final_angmom": ("final_state", slice(9, 12)),
          "final_thrust_N": ("final_state", slice(12, 16)),
          "final_thrust_rate_Nps": ("final_state", slice(16, 20)),
          "final_err": ("final_state", slice(20, 26))}
WORKERS = 4
CHUNK = 64


def commands(row) -> dict:
    return {k: row[COLS[k]] for k in chain.COMMANDS}


def cases(records, start: dict, lead_in: int, lanes: int, rng,
          per_stream) -> dict:
    """{(stream, lane position): [(record index, stream tick, the
    program's commands the tick before)]}, at most ``per_stream`` ticks of
    each (``"all"``: every tick), drawn with ``rng``. ``records`` [(stream,
    tick, rows [lanes, width])] in window order; ``start`` {stream: rows of
    the lead-in}."""
    prev, out = {}, {}
    for i, (s, t, rows) in enumerate(records):
        before = start[s] if t == lead_in else prev[s]
        for pos in range(lanes):
            out.setdefault((s, pos), []).append(
                (i, t, commands(before[pos])))
        prev[s] = rows
    for key, todo in out.items():
        if per_stream != "all" and len(todo) > per_stream:
            keep = np.sort(rng.choice(len(todo), size=per_stream,
                                      replace=False))
            out[key] = [todo[j] for j in keep]
    return out


def first_passes(records, lead_in: int) -> dict:
    """{stream: [record index]} of the first pass of each stream in the
    window, in tick order from the lead-in (a prefix of the pass where the
    window holds no more). A pass's records lie together."""
    out = {}
    for i, (s, t, _) in enumerate(records):
        run = out.get(s)
        if run is None:
            if t == lead_in:
                out[s] = [i]
        elif run[-1] == i - 1 and records[i - 1][1] == t - 1:
            run.append(i)
    return out


def references(config_path, stream_path, jitter, todo: dict,
               passes: dict, start: dict, lead_in: int):
    """The reference's outputs, computed in a few worker processes of their
    own (NumPy only, one thread each): step by step for every case of
    ``todo`` (see :func:`cases`), {(stream, pos): [outputs]}, and chained
    over each of ``passes`` (see :func:`first_passes`) from the lead-in's
    commands ``start``, {(stream, pos): {output: [ticks, width]}}."""
    tasks = []
    for key, cs in todo.items():
        s, pos = key
        for at in range(0, len(cs), CHUNK):
            part = [(t, prev) for _, t, prev in cs[at:at + CHUNK]]
            tasks.append(("step", key, chain.step_lane_task,
                          (str(config_path), str(stream_path(s)),
                           jitter[pos], part)))
    for s, run in passes.items():
        for pos in range(len(jitter)):
            tasks.append(("chain", (s, pos), chain.run_lane_task,
                          (str(config_path), str(stream_path(s)),
                           jitter[pos], lead_in, commands(start[s][pos]),
                           len(run))))
    steps = {key: [] for key in todo}
    chained = {}
    if not tasks:
        return steps, chained
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(WORKERS, len(tasks)),
                             mp_context=ctx) as pool:
        futures = [(kind, key, pool.submit(fn, args))
                   for kind, key, fn, args in tasks]
        for kind, key, fut in futures:
            if kind == "step":
                steps[key] += fut.result()
            else:
                chained[key] = fut.result()
    return steps, chained


def _widest(worst: dict, prefix: str, row, ref) -> None:
    for name, (k, part) in GROUPS.items():
        got = row[COLS[k]][part]
        ok = np.isfinite(got)
        gap = np.abs(got - ref[k][part])[ok]
        if gap.size:
            worst[prefix + name] = max(worst[prefix + name],
                                       float(gap.max()))


def compare(records, todo: dict, steps: dict, passes: dict,
            chained: dict) -> dict:
    """Every candidate number over the cases of ``todo`` and the chained
    ``passes``."""
    worst = {p + name: 0.0 for p in ("", "chain_") for name in GROUPS}
    nonfinite = 0
    for key, cs in todo.items():
        _, pos = key
        for (i, _, _), ref in zip(cs, steps[key]):
            row = np.asarray(records[i][2][pos], np.float64)
            _widest(worst, "", row, ref)
            nonfinite += int((~np.isfinite(row)).sum())
    for (s, pos), ref in chained.items():
        for j, i in enumerate(passes[s]):
            row = np.asarray(records[i][2][pos], np.float64)
            _widest(worst, "chain_", row, {k: v[j] for k, v in ref.items()})
    worst["nonfinite"] = nonfinite
    return worst


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names; a number without a limit fails."""
    table, ok = {}, True
    for name, lim in limits.items():
        val = numbers[name]
        table[name] = {"value": val, "limit": lim}
        if lim is None or not np.isfinite(val) or val > lim:
            ok = False
    return ok, table
