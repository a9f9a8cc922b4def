"""The sweep loop: the Monte-Carlo robustness sweep, perturbed flights of
the paper's mission from one airborne branch, each pass one call of the
program's ``parallel/monte_carlo.py`` ``run_sweep`` over every lane with
the recovery retry on.

A sweep mix (``mpcbench/traffic/<name>.json``, ``"loop": "sweep"``)
holds, besides the keys every mix has (``core/traffic.py``), the flight
mix's keys (``loops/flight.py``) with these meanings:

- ``decisions``: ``batch_wide`` (the sweep's: the solver's gates and the
  retry's predicate read back once for all lanes) or ``per_lane``;
- ``start``: the recorded settled state the controller is configured from
  at mission start (``mpcbench/streams/<start>.npz``);
- ``starts``: the recorded mid-mission states the sweep branches from, in
  turn, one pass each;
- ``ticks``: ticks a pass, each one ``ClosedLoop.tick`` of every lane
  (the snapshot, an ``mpc_tick``, the commands applied, the plant's
  substeps), the retry where a lane's solve failed, and the statistics;
- ``wind_sigma_N``: σ of each lane's constant world-frame wind at the
  base, an axis;
- ``warm_passes``: passes of each branch run in set-up (they capture the
  plant's and the snapshot's CUDA graphs at the mix's lanes);
- ``check_lanes``, ``check_ticks``, ``chain_ticks``: as the flight's.

The configuration's ``scenario`` gives the other perturbations (turbine
mismatch, initial base-velocity and posture noise, the model-mismatch axes)
and the CoM error at which a lane fails; its ``recover`` turns the retry
on. Set-up builds the flight loop as ``loops/flight.py`` does, configures
the controller on the settled state (one lane: the sweep shares the
problem), restores each branch and perturbs it for every lane with the
program's ``make_batched_carry``, seeded from ``--seed`` (the program's
generator: every seed does the same work, only the draw moves), and runs
``warm_passes``. It refuses at once a program whose sweep keeps no
counters or hands its per-tick callback no carry.

A pass clones its branch's batched carry and calls ``run_sweep`` for the
pass's ticks; the callback keeps, on the device, each tick's row of every
checked lane (:func:`row`: the flight's row and the controller's CoM
reference) and every lane's solver statuses and guard firings; the pass's
``SweepResult`` stays beside its last tick. The device is synchronised
once a pass.

The check (``mpcbench/reference/sweep.py``, float64, nothing of the
program) gives the flight's numbers (``loops/flight.py`` ``NUMBERS``) and
``com_ref_m`` step by step over ``check_ticks`` drawn ticks of each pass
and each checked lane, from the program's plant state and its commands of
the tick before under the lane's wind and thrust scale; ``chain_`` the
same over the reference's own closed loop of the first ``chain_ticks``
ticks of the first pass from each branch, from each checked lane's
perturbed start; and the sweep's statistics (:data:`STATISTICS`): each
checked lane's largest CoM error against the reference's own snapshots and
CoM references of every tick of the pass (the task of a lane's last drawn
ticks runs on to the pass's end, observing), the rest against the
reference's reduction of the recorded statuses and the program's per-lane
vectors.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from mpcbench.core import driver, port, spec
from mpcbench.loops import flight
from mpcbench.reference import sweep as reference

KEYS = flight.KEYS
KERNELS = flight.KERNELS
WORKERS = 6
CHUNK = flight.CHUNK
# the program's sweep counters this loop needs
COUNTERS = (("_sweep_tick", "ticks"), ("_sweep_tick", "retries"),
            ("run_sweep", "sweeps"))
# the controller's CoM reference after the flight's row
COM_REF = slice(sum(flight.WIDTHS.values()), sum(flight.WIDTHS.values()) + 3)
# the sweep's statistics the check compares, each the largest gap over the
# window's passes: the checked lanes' largest CoM error against the
# reference's over every tick of the pass (m); lanes whose any-unsolved
# flag differs from their statuses'; the status histogram's cells that
# differ (every lane); the result's lane counts against the reduction of
# its per-lane vectors (self-consistency of the reduction); its mean and
# largest CoM error (m) and solved share likewise
STATISTICS = ("lane_max_com_err_m", "lane_solver_bad", "status_counts",
              "n_failed", "n_solver_bad", "mean_com_err_m", "max_com_err_m",
              "solved_frac")


def validate(traffic: dict, path) -> None:
    flight.validate(traffic, path)


def require(monte_carlo) -> None:
    """Refuse a program whose sweep keeps none of :data:`COUNTERS`: its
    ``run_sweep`` hands the per-tick callback no carry either."""
    missing = [f"{f}.{a}" for f, a in COUNTERS
               if type(getattr(getattr(monte_carlo, f), a, None)) is not int]
    if missing:
        raise RuntimeError(
            "the sweep cell needs a parallel/monte_carlo.py whose run_sweep "
            "hands its per-tick callback the carry and keeps the counters "
            f"{', '.join(missing)}; this program has none of them")


def draw(traffic: dict, seed: int):
    """(the sorted checked lanes, the generator of the checked ticks),
    from the seed."""
    lane_rng, tick_rng = (np.random.default_rng(s) for s in
                          np.random.SeedSequence(abs(int(seed))).spawn(2))
    lanes = int(traffic["lanes"])
    k = min(int(traffic["check_lanes"]), lanes)
    return np.sort(lane_rng.choice(lanes, size=k, replace=False)), tick_rng


def row(tel, carry) -> torch.Tensor:
    """[lanes, 166]: the flight's row of a tick (``loops/flight.py``
    ``row``) and the controller's CoM reference (:data:`COM_REF`)."""
    rows = flight.row(dict(joints_pos_ref=tel.joints_pos_ref,
                           throttle=tel.throttle,
                           thrust_des=tel.thrust_desired,
                           thrust_dot_des=tel.thrust_desired_dot),
                      tel.com_position,
                      torch.cat((tel.linear_momentum, tel.angular_momentum),
                                1), carry.plant)
    return torch.cat((rows, tel.com_position_desired), 1)


def start_rows(carry, lanes) -> np.ndarray:
    """The batched start of ``lanes`` as rows (host, float64): the carry's
    commands, no snapshot, the lanes' plant states."""
    from ironcub_mpc_tpu_torch.core.types import tree_map

    one = tree_map(lambda t: t.index_select(0, lanes), carry)
    m, p = one.mpc, one.plant
    r = flight.row(dict(joints_pos_ref=m.joints_pos_ref,
                        throttle=m.throttle_cmd, thrust_des=m.thrust_des,
                        thrust_dot_des=m.thrust_dot_des),
                   torch.zeros_like(p.base_p), torch.zeros_like(p.base_v), p)
    r = torch.cat((r, torch.zeros_like(p.base_p)), 1)
    return r.cpu().numpy().astype(np.float64)


class Loop:
    """The sweep after set-up: the closed loop, its problem, each branch's
    batched carry perturbed on the device, and the seed's draw."""

    def __init__(self, cell, seed):
        from ironcub_mpc_tpu_torch.parallel import monte_carlo

        require(monte_carlo)
        from ironcub_mpc_tpu_torch.core.config import SimConfig
        from ironcub_mpc_tpu_torch.core.types import tree_map
        from ironcub_mpc_tpu_torch.runtime import checkpoint
        from ironcub_mpc_tpu_torch.runtime import flight as program_flight
        from ironcub_mpc_tpu_torch.sim.plant import PlantParams

        self.traffic = traffic = cell.traffic
        self.config_path = cell.config_path
        self.dev = cell.dev
        config = cell.config
        ctl = port.build(config, traffic)
        sim = SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["sim"].items()})
        self.loop, pos_traj, alpha_traj = program_flight.build_flight_loop(
            device=self.dev, mpc_cfg=ctl.cfg, settings=ctl.settings,
            plant_params=PlantParams(**config["plant"]), sim_cfg=sim)
        flight._data_files(config)

        def mpc_step(cfg, sched, sel, settings, problem, carry, snap, est):
            # the retry's recovery settings reach the program
            return port.tick(ctl._replace(settings=settings), problem, carry,
                             snap, est)

        self.loop.mpc_tick = mpc_step
        if self.dev.type == "cuda":
            port.build_kernels(KERNELS)
        sc = config["scenario"]
        self.scen = monte_carlo.ScenarioConfig(
            wind_force_std=float(traffic["wind_sigma_N"]),
            thrust_scale_std=sc["thrust_scale_std"],
            base_vel_std=sc["base_vel_std"],
            joint_pos_std=sc["joint_pos_std"],
            com_err_fail=sc["com_err_fail_m"],
            mass_scale_std=sc["mass_scale_std"],
            jet_pos_std_m=sc["jet_pos_std_m"])
        self.recover = bool(config["recover"])
        self.check_lanes, self.tick_rng = draw(traffic, seed)
        self.check_idx = torch.as_tensor(self.check_lanes, device=self.dev)
        z = np.load(spec.stream_path(traffic["start"]))
        settled = checkpoint.unflatten(
            flight._arrays(z, "plant"), "plant",
            program_flight.standing_state(self.loop.plant,
                                          sim.initial_position_deg))
        self.problem, one = self.loop.configure(
            settled, *program_flight.mission_inputs(pos_traj, alpha_traj))
        self.starts, self.start_rows, self.lanes_of = {}, {}, {}
        for i, s in enumerate(traffic["starts"]):
            carry = checkpoint.unflatten(
                flight._arrays(np.load(spec.stream_path(s)), "carry"),
                "carry", one)
            batched = monte_carlo.make_batched_carry(
                carry, cell.lanes, self.scen, seed=abs(int(seed)) + i)
            self.starts[s] = batched
            self.start_rows[s] = start_rows(batched, self.check_idx)
            p = tree_map(lambda t: t.index_select(0, self.check_idx),
                         batched.plant)
            self.lanes_of[s] = [
                dict(wind=w, thrust_scale=k, mass_scale=m, jet_pos_offset=o)
                for w, k, m, o in zip(*(
                    t.cpu().numpy().astype(np.float64) for t in
                    (p.wind_force, p.thrust_scale, p.mass_scale,
                     p.jet_pos_offset)))]
        self.passes = list(traffic["starts"])
        self.lead_in_status = {}
        for _ in range(int(traffic["warm_passes"])):
            for s in self.passes:
                self.run_pass(s, [], [])
        driver.sync(self.dev)

    def run_pass(self, s, records, statuses, n_ticks=None, latencies=None,
                 deadline=None, span=None):
        """One sweep from branch ``s`` (its first ``n_ticks`` ticks); a pass
        runs whole, so it never stops at ``deadline``."""
        from ironcub_mpc_tpu_torch.parallel import monte_carlo

        span = span or driver.NOSPAN
        ticks = int(self.traffic["ticks"])
        n = ticks if n_ticks is None else min(n_ticks, ticks)
        first = len(records)

        def on_tick(tel, carry):
            with span("commands"):
                rows = row(tel, carry).index_select(0, self.check_idx)
            records.append((s, len(records) - first, rows, tel.guard_fired))
            statuses.append(tel.solver_status)

        res = monte_carlo.run_sweep(self.loop, self.problem,
                                    port.clone(self.starts[s]), n,
                                    scen=self.scen, recover=self.recover,
                                    on_tick=on_tick)
        records[-1] = (*records[-1], res)
        with span("pass_sync"):
            driver.sync(self.dev)
        return True

    def check(self, records, statuses, detail=None) -> dict:
        """The candidate numbers of a window's records, once the program's
        state is freed."""
        host = [(s, t, np.asarray(r.cpu().numpy(), np.float64))
                for s, t, r, *_ in records]
        guard = torch.stack([r[3] for r in records]).cpu().numpy()
        status = torch.stack(statuses).cpu().numpy()
        results = {i: {k: v.cpu().numpy() for k, v in r[4]._asdict().items()
                       if v is not None}
                   for i, r in enumerate(records) if len(r) == 5}
        records.clear()
        statuses.clear()
        self.starts.clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        runs = flight.passes(host)
        steps, observed, chained = self._references(host, runs)
        numbers = flight.compare(host, steps, runs, chained)
        numbers.update(com_ref(host, steps, runs, chained))
        numbers.update(self._statistics(runs, observed, status, guard,
                                        results))
        numbers["nonfinite"] = int(sum((~np.isfinite(r)).sum()
                                       for _, _, r in host))
        if detail is not None:
            detail.update(numbers=numbers, cases=len(steps),
                          chained=sum(len(v) for v in chained.values()),
                          passes=[dict(n_failed=int(r["n_failed"]),
                                       n_ticks_retried=int(
                                           r["n_ticks_retried"]),
                                       status_counts=r["status_counts"]
                                       .tolist())
                                  for r in results.values()])
        return numbers

    def _statistics(self, runs, observed, status, guard, results) -> dict:
        """The sweep's statistics (:data:`STATISTICS`) of each pass: the
        checked lanes' largest CoM error against the reference's over its
        own snapshots and CoM references of every tick (``observed``); the
        rest against the reference's reduction of the recorded statuses and
        the program's per-lane vectors."""
        worst = {k: 0.0 for k in STATISTICS}
        com_fail = float(self.scen.com_err_fail)
        lanes = range(len(self.check_lanes))
        for _, idx in runs:
            res = results[idx[-1]]
            ref_err = reference.com_errors(
                [[observed[i, pos]["com"] for pos in lanes] for i in idx],
                [[observed[i, pos]["com_ref"] for pos in lanes] for i in idx])
            bad = reference.solver_bad(status[idx])
            counts = reference.status_counts(status[idx], guard[idx])
            red = reference.reduce(res["lane_max_err"], bad, counts,
                                   len(idx), com_fail)
            gaps = dict(
                lane_max_com_err_m=_gap(
                    res["lane_max_err"][self.check_lanes],
                    ref_err.max(axis=0)),
                lane_solver_bad=float((res["lane_solver_bad"] != bad).sum()),
                status_counts=float(np.abs(
                    res["status_counts"] - red["status_counts"]).sum()),
                n_failed=_gap(res["n_failed"], red["n_failed"]),
                n_solver_bad=_gap(res["n_solver_bad"], red["n_solver_bad"]),
                mean_com_err_m=_gap(res["mean_com_err"], red["mean_com_err"]),
                max_com_err_m=_gap(res["max_com_err"], red["max_com_err"]),
                solved_frac=_gap(res["solved_frac"], red["solved_frac"]))
            for k, v in gaps.items():
                worst[k] = max(worst[k], v)
        return worst

    def _references(self, host, runs):
        """The reference's outputs in a few worker processes, as the
        flight's (``loops/flight.py`` ``Loop._references``), each lane
        under its own perturbations and chained from its own start."""
        tr = self.traffic
        config = str(self.config_path)
        start = str(spec.stream_path(tr["start"]))
        tasks = []
        for s, idx in runs:
            picked = flight._picked(len(idx), tr["check_ticks"],
                                    self.tick_rng)
            for pos in range(len(self.check_lanes)):
                entries = []
                for j, i in enumerate(idx):
                    before = (self.start_rows[s][pos] if j == 0
                              else host[idx[j - 1]][2][pos])
                    entries.append((flight._state(before),
                                    flight._commands(before),
                                    flight._commands(host[i][2][pos])))
                for at in range(0, len(picked), CHUNK):
                    chunk = picked[at:at + CHUNK]
                    # the last task runs to the pass's end: the reference
                    # sees every tick's CoM error
                    end = (len(idx) if at + CHUNK >= len(picked)
                           else chunk[-1] + 1)
                    todo = [(k in chunk, *entries[k]) for k in range(end)]
                    tasks.append(("step", [(idx[k], pos) for k in range(end)],
                                  reference.step_pass_task,
                                  (config, start, str(spec.stream_path(s)),
                                   self.lanes_of[s][pos], todo)))
        for s, idx in flight.first_passes(runs).items():
            n = min(int(tr["chain_ticks"]), len(idx))
            for pos in range(len(self.check_lanes)):
                tasks.append(("chain", (s, pos), reference.chain_pass_task,
                              (config, start, str(spec.stream_path(s)),
                               self.lanes_of[s][pos],
                               flight._state(self.start_rows[s][pos]), n)))
        steps, observed, chained = {}, {}, {}
        if not tasks:
            return steps, observed, chained
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
                    for k, ref in zip(key, fut.result()):
                        observed[k] = ref["observed"]
                        if "commands" in ref:
                            steps[k] = ref
                else:
                    chained[key] = fut.result()
        return steps, observed, chained


def _gap(a, b) -> float:
    """The largest |a − b|; 0 where both hold the same infinity."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.where(a == b, 0.0, a - b))
    return float(np.nan_to_num(gap, nan=np.inf).max())


def com_ref(host, steps: dict, runs, chained: dict) -> dict:
    """``com_ref_m`` and ``chain_com_ref_m``: the rows' CoM reference
    against the reference controller's, step by step and chained."""
    worst = dict(com_ref_m=0.0, chain_com_ref_m=0.0)

    def widen(key, got, ref):
        gap = np.abs(got - ref)[np.isfinite(got)]
        if gap.size:
            worst[key] = max(worst[key], float(gap.max()))

    for (i, pos), ref in steps.items():
        widen("com_ref_m", host[i][2][pos][COM_REF],
              ref["observed"]["com_ref"])
    first = flight.first_passes(runs)
    for (s, pos), refs in chained.items():
        for i, ref in zip(first[s], refs):
            widen("chain_com_ref_m", host[i][2][pos][COM_REF],
                  ref["observed"]["com_ref"])
    return worst
