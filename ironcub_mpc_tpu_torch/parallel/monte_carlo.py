"""Monte-Carlo robustness sweeps (counterpart of
``ironcub_mpc_tpu/parallel/monte_carlo.py``).

Thousands of perturbed closed-loop rollouts — wind gusts, thrust-model
mismatch, initial-state noise, model mismatch — run as one batched rollout
over the scenario lanes, split over the processes of a :class:`~.mesh.Mesh`;
statistics (success rates, tracking-error moments, worst case, the status
histogram) accumulate on the device, O(1) per lane, and are reduced with
``torch.distributed`` collectives, so only scalars and two per-lane vectors
leave the device.

Failure handling: per-lane solver status and non-finite guards classify
diverged rollouts; they are masked out of the statistics and reported,
never allowed to poison the reduction.

Batch-wide decisions are per rank, as they are per shard in JAX: there the
carried-inverse guard's ``guard_axis`` and the recovery predicate range over
the vmap axis inside each shard, never across devices. Here they range over
the lanes of one rank (``ADMMSettings.batch_guard=True``).

While a profiler records, a tick's recovery predicate is the span
``sweep.gate``, its re-run (where it runs) ``sweep.retry``, the
accumulators ``sweep.stats``, and the final reduction ``sweep.reduce``.
Counters: ``_sweep_tick.ticks``, ``_sweep_tick.retries`` (ticks that re-ran)
and ``run_sweep.sweeps``.

Performance note: the JAX tools switch the Pallas kernels off for batched
sweeps, where the batched-GEMM path was faster on a TPU. On the H100 the
plain PyTorch twins are 20–40× slower than the hand-written kernels at
batch 256 (PERF.md), so a sweep here keeps ``kernel_mode="auto"``, with
``batch_guard=True``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..core.types import tree_map
from ..ops import admm
from ..qp import condensed
from ..runtime import checkpoint
from ..runtime.loop import ClosedLoop, LoopCarry, TickTelemetry
from ..utils.profiling import span
from .mesh import Mesh, scenario_shard


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Perturbation magnitudes for a robustness sweep."""

    wind_force_std: float = 10.0       # N, constant gust per scenario
    thrust_scale_std: float = 0.05     # multiplicative turbine mismatch
    base_vel_std: float = 0.05         # m/s initial base-velocity noise
    joint_pos_std: float = 0.01        # rad initial posture noise
    com_err_fail: float = 0.5          # m: tracking error declaring failure
    # model-mismatch axis: the plant flies perturbed inertial parameters /
    # jet placements while the controller keeps the nominal model
    mass_scale_std: float = 0.0        # per-link mass+inertia rel. error
    jet_pos_std_m: float = 0.0         # m, per-jet placement error (link frame)


class SweepResult(NamedTuple):
    n_scenarios: torch.Tensor
    n_failed: torch.Tensor          # diverged (non-finite) or failure-threshold hit
    n_solver_bad: torch.Tensor      # any non-solved tick (post-recovery)
    mean_com_err: torch.Tensor      # mean over healthy scenarios [m]
    max_com_err: torch.Tensor       # worst healthy scenario [m]; -inf if none
    solved_frac: torch.Tensor       # fraction of (scenario, tick) solved
    # per-status tick counts over all (scenario, tick) pairs, post-recovery
    # when recovery is on, in STATUS_COLS order
    status_counts: torch.Tensor = None      # [6] int
    n_ticks_recovered: torch.Tensor = None  # bad ticks fixed by the retry
    n_ticks_retried: torch.Tensor = None    # bad ticks that got a retry
    # per-lane forensics [n]: worst tracking error and whether any tick
    # stayed non-solved
    lane_max_err: torch.Tensor = None
    lane_solver_bad: torch.Tensor = None


# status_counts column order
STATUS_COLS = ("solved", "solved_inaccurate", "primal_infeasible",
               "dual_infeasible", "max_iter", "guard_fired")


def make_batched_carry(carry: LoopCarry, n: int, scen: ScenarioConfig,
                       seed: int = 0) -> LoopCarry:
    """Replicate a configured one-lane carry across ``n`` scenarios and apply
    i.i.d. perturbations to the plant state, drawn from a
    ``torch.Generator`` on the carry's device seeded by ``seed`` (the JAX
    package draws from threefry keys: the same seed gives other numbers)."""
    if carry.plant.base_p.shape[0] != 1:
        raise ValueError("make_batched_carry replicates a one-lane carry; "
                         f"got {carry.plant.base_p.shape[0]} lanes")
    batched = tree_map(lambda t: t.expand(n, *t.shape[1:]).clone(), carry)
    p = batched.plant
    dev, dt = p.base_p.device, p.base_p.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    n_links = p.mass_scale.shape[-1]
    plant = p._replace(
        wind_force=scen.wind_force_std * normal(n, 3),
        thrust_scale=1.0 + scen.thrust_scale_std * normal(n, 4),
        base_v=p.base_v + scen.base_vel_std * normal(n, 6),
        q=p.q + scen.joint_pos_std * normal(*p.q.shape),
        mass_scale=torch.clamp(
            1.0 + scen.mass_scale_std * normal(n, n_links), 0.2, 5.0),
        jet_pos_offset=scen.jet_pos_std_m * normal(n, 4, 3))
    return batched._replace(plant=plant)


def recovery_settings(settings: admm.ADMMSettings) -> admm.ADMMSettings:
    """Solver settings for the failure-recovery retry of a bad tick: fresh
    factorisation and ρ reset (``kinv_reset`` ignores the carried inverse
    and ρ for this solve and writes the fresh factorisation back, so a
    corrupted carry cannot re-trigger the retry on every later tick), more
    iterations and extra adaptive-ρ marks, no early exit."""
    return dataclasses.replace(
        settings, kinv_reset=True, max_iter=max(200, 2 * settings.max_iter),
        rho_update_iters=(25, 75, 150), term_check_every=0)


def _pick(mask, new, old):
    """``new`` where the lane's ``mask`` is set, else ``old``, leaf by
    leaf."""
    return tree_map(lambda o, n: torch.where(
        mask.reshape(mask.shape + (1,) * (o.dim() - 1)), n, o), old, new)


class _Acc(NamedTuple):
    """The per-lane accumulators of a sweep."""

    max_err: torch.Tensor     # [n] float
    sum_solved: torch.Tensor  # [n] float
    any_bad: torch.Tensor     # [n] bool
    cnt: torch.Tensor         # [n, 6] int32, STATUS_COLS
    n_rec: torch.Tensor       # [n] int32
    n_ret: torch.Tensor       # [n] int32


def _new_acc(n, dev) -> _Acc:
    f = dict(device=dev, dtype=torch.float32)
    i = dict(device=dev, dtype=torch.int32)
    return _Acc(torch.zeros(n, **f), torch.zeros(n, **f),
                torch.zeros(n, device=dev, dtype=torch.bool),
                torch.zeros((n, len(STATUS_COLS)), **i),
                torch.zeros(n, **i), torch.zeros(n, **i))


def _sweep_tick(loop: ClosedLoop, problem, carry: LoopCarry, acc: _Acc,
                rec_settings):
    """One tick of every lane, the recovery retry and the statistics."""
    _sweep_tick.ticks += 1
    plant = loop.plant
    noisy = plant.sim_cfg.simulate_noise
    gen_state = plant.noise_state() if noisy and rec_settings else None
    carry0 = carry
    carry, tel = loop.tick(problem, carry)
    n_rec = acc.n_rec
    bad = None
    if rec_settings is not None:
        # failure recovery: when any lane of this rank is bad, re-run the
        # tick for every lane with a fresh factorisation and more
        # iterations, and keep the retry for the bad lanes (one host
        # read-back per tick for the predicate, counted by batch_any)
        with span("sweep.gate"):
            bad = tel.solver_status >= admm.PRIMAL_INFEASIBLE
            retry = condensed.batch_any(bad)
        if retry:
            _sweep_tick.retries += 1
            with span("sweep.retry"):
                if gen_state is not None:
                    # the retry sees the sensor noise of the first attempt,
                    # as the JAX retry re-draws from the lane's saved key
                    plant.set_noise_state(gen_state)
                carry_r, tel_r = loop.tick(problem, carry0, rec_settings)
                carry = _pick(bad, carry_r, carry)
                tel = _pick(bad, tel_r, tel)
                rec_ok = bad & (
                    (tel_r.solver_status == admm.SOLVED)
                    | (tel_r.solver_status == admm.SOLVED_INACCURATE))
                n_rec = n_rec + rec_ok.to(torch.int32)
    with span("sweep.stats"):
        n_ret = acc.n_ret if bad is None else acc.n_ret + bad.to(torch.int32)
        err = torch.linalg.vector_norm(
            tel.com_position - tel.com_position_desired, dim=-1)
        err = torch.where(torch.isfinite(err), err,
                          torch.full_like(err, float("inf")))
        st = tel.solver_status
        solved = (st == admm.SOLVED) | (st == admm.SOLVED_INACCURATE)
        cnt = acc.cnt + torch.stack([
            st == admm.SOLVED, st == admm.SOLVED_INACCURATE,
            st == admm.PRIMAL_INFEASIBLE, st == admm.DUAL_INFEASIBLE,
            st == admm.MAX_ITER_REACHED, tel.guard_fired],
            dim=-1).to(torch.int32)
        acc = _Acc(max_err=torch.maximum(acc.max_err, err.to(torch.float32)),
                   sum_solved=acc.sum_solved + solved.to(torch.float32),
                   any_bad=acc.any_bad | (st >= admm.PRIMAL_INFEASIBLE),
                   cnt=cnt, n_rec=n_rec, n_ret=n_ret)
    return carry, acc, tel


_sweep_tick.ticks = 0
_sweep_tick.retries = 0


def _ckpt_path(checkpoint_dir, mesh: Mesh | None) -> Path:
    """One file per scenario slice: the ranks of a kkt group run the same
    lanes and share it."""
    parts = 1 if mesh is None else mesh.n_scenario
    name = ("sweep_state.pt" if parts == 1
            else f"sweep_state.rank{mesh.scenario_index}-of-{parts}.pt")
    return Path(checkpoint_dir) / name


def _kkt_barrier(mesh: Mesh | None):
    """Wait for the other ranks of this rank's kkt group, which share its
    checkpoint file: kkt coordinate 0 alone writes it, so its replicas
    read it only once that rank has written, and it writes only once they
    have read."""
    if mesh is not None and mesh.kkt_group is not None:
        dist.barrier(group=mesh.kkt_group)


def _reduce(mesh: Mesh | None, acc: _Acc, n: int, n_ticks: int,
            scen: ScenarioConfig) -> SweepResult:
    """The sweep's statistics over the scenario axis (the ranks that share
    this rank's kkt coordinate; the replicas of a kkt group count once):
    sums and maxima with ``all_reduce``, the per-lane vectors with
    ``all_gather``, solved_frac as the mean over scenario ranks of each
    one's mean (JAX's ``pmean``)."""
    group = None if mesh is None else mesh.scenario_group
    max_err = acc.max_err
    failed = ~torch.isfinite(max_err) | (max_err > scen.com_err_fail)
    healthy = ~failed
    sums = torch.stack([
        healthy.sum().to(torch.float64),
        torch.where(healthy, max_err, torch.zeros_like(max_err)).sum()
        .to(torch.float64),
        failed.sum().to(torch.float64),
        acc.any_bad.sum().to(torch.float64),
        (acc.sum_solved / n_ticks).mean().to(torch.float64)])
    worst = torch.where(healthy, max_err,
                        torch.full_like(max_err, -float("inf"))).max()
    counts = torch.cat([acc.cnt.sum(dim=0), acc.n_rec.sum()[None],
                        acc.n_ret.sum()[None]]).to(torch.int64)
    lanes = [max_err, acc.any_bad.to(torch.uint8)]
    world = 1
    if group is not None:
        world = mesh.n_scenario
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        gathered = []
        for t in lanes:
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            gathered.append(torch.cat(parts))
        lanes = gathered
    n_h, sum_err, n_failed, n_bad, solved = sums
    n_cols = len(STATUS_COLS)
    return SweepResult(
        n_scenarios=torch.tensor(n, device=max_err.device),
        n_failed=n_failed.to(torch.int64),
        n_solver_bad=n_bad.to(torch.int64),
        mean_com_err=(sum_err / torch.clamp_min(n_h, 1.0)).to(torch.float32),
        max_com_err=worst,
        solved_frac=(solved / world).to(torch.float32),
        status_counts=counts[:n_cols],
        n_ticks_recovered=counts[n_cols],
        n_ticks_retried=counts[n_cols + 1],
        lane_max_err=lanes[0],
        lane_solver_bad=lanes[1].to(torch.bool))


def run_sweep(loop: ClosedLoop, problem, batched_carry: LoopCarry,
              n_ticks: int, mesh: Mesh | None = None,
              scen: ScenarioConfig = ScenarioConfig(),
              chunk_ticks: int | None = None,
              checkpoint_dir: str | None = None,
              recover: bool = False,
              on_tick: Callable[[TickTelemetry, LoopCarry], None] | None = None
              ) -> SweepResult:
    """Run every scenario for ``n_ticks`` and reduce the statistics on the
    device.

    ``batched_carry`` holds all ``n`` lanes; this rank runs its
    :func:`~.mesh.scenario_shard` of them on the device they live on (one
    process, ``mesh=None``: all of them). Statistics accumulate per lane
    between ticks; nothing is read back per tick but the solver's own
    batch-wide gates and, with ``recover``, the recovery predicate.

    ``chunk_ticks`` splits the rollout into chunks. ``checkpoint_dir``
    persists (this rank's carry, the accumulators, the tick cursor and the
    plant's sensor-noise generator) after every chunk to
    ``checkpoint_dir/sweep_state.pt`` (one file per scenario slice on a
    mesh of several, written by the slice's kkt coordinate 0); calling
    run_sweep again with the same directory resumes from
    the last completed chunk and gives the result of an uninterrupted run.

    ``on_tick``, if given, is called after every tick with this rank's
    telemetry of it, the recovery retry's for the lanes it re-ran: a trace
    of the sweep lane-tick by lane-tick (status, residuals) for checks that
    the histogram alone cannot make. It is handed this rank's carry after
    the tick beside it, ``on_tick(telemetry, carry)``: the plant state a
    check steps a reference from. Nothing is read back unless it does.
    """
    run_sweep.sweeps += 1
    n = batched_carry.plant.base_p.shape[0]
    shard = scenario_shard(mesh, n)
    carry = tree_map(lambda t: t[shard], batched_carry)
    dev = carry.plant.base_p.device
    chunk = int(chunk_ticks) if chunk_ticks else int(n_ticks)
    rec_settings = recovery_settings(loop.settings) if recover else None
    acc = _new_acc(shard.stop - shard.start, dev)
    done = 0
    path = None
    if checkpoint_dir is not None:
        path = _ckpt_path(checkpoint_dir, mesh)
        _kkt_barrier(mesh)
        if path.exists():
            flat = checkpoint.read(path)
            carry = checkpoint.unflatten(flat, "carry", carry)
            acc = checkpoint.unflatten(flat, "acc", acc)
            done = int(flat["done"])
            loop.plant.set_noise_state(flat[checkpoint.NOISE_KEY])
        _kkt_barrier(mesh)
        if mesh is not None and mesh.kkt_index:
            path = None
    while done < n_ticks:
        length = min(chunk, n_ticks - done)
        for _ in range(length):
            carry, acc, tel = _sweep_tick(loop, problem, carry, acc,
                                          rec_settings)
            if on_tick is not None:
                on_tick(tel, carry)
        done += length
        if path is not None:
            checkpoint.write(path, {
                **checkpoint.flatten("carry", carry),
                **checkpoint.flatten("acc", acc),
                "done": torch.tensor(done),
                checkpoint.NOISE_KEY: loop.plant.noise_state()})
    with span("sweep.reduce"):
        return _reduce(mesh, acc, n, n_ticks, scen)


run_sweep.sweeps = 0
