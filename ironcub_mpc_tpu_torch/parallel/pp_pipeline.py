"""Pipeline parallelism: the four condensed-tick stages spread over a
``"pipe"`` axis of devices, with scenario micro-batches streaming through
(counterpart of ``ironcub_mpc_tpu/parallel/pp_pipeline.py``).

The condensed MPC tick factors into four stages with a natural
producer/consumer chain:

    S0 prep        — reference shift, linearisation, initial state
    S1 condense    — per-tick gradients + exact state elimination
    S2 solve       — warm-started box-QP ADMM (the kernels' stage)
    S3 extract     — solution slicing + command integration

JAX runs them under ``shard_map`` over a four-device mesh: one program
drives the four devices, every device applies its stage to its resident
payload each step, and ``ppermute`` passes the payloads one stage on
(GPipe, ``n_micro + 3`` steps). Here one controlling thread is that
program. Stage i runs on ``devices[i]`` on a CUDA stream of its own, and
the ``ppermute`` to stage i + 1 is a ``.to(devices[i + 1],
non_blocking=True)`` plus an event that the next stage's stream waits on
(on one device only the wait). On several cards the stages overlap through
peer copies; on one card their four streams overlap; on the CPU they run
in turn. JAX's zero payloads and its ``where(stage_id …)`` blends exist
because SPMD runs every stage on every device every step; the loop below
runs stage i on micro-batch t − i only, which gives the same lanes.

The ring is slim, as JAX's (debug-log mode off): the measured robot state
(``snaps``/``est``) never rides it (S0 reads it from the inputs); ``F``/``f``
are cut to knots (0, −1) after condensing, the only knots the solve's
``states`` are read at (the H/q fold that needs all of them happens inside
S1); and the refreshed K⁻¹/ρ are folded into the carry at S2, so the
solution carries no second [nU, nU] matrix to S3. With
``enable_debug_log_mode`` the full shapes are kept.

Decisions are per lane: JAX vmaps every stage without an axis name, so no
batch-wide guard can be bound there, and ``pipeline_tick`` refuses
``settings.batch_guard=True``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..core.config import MPCConfig
from ..core.types import MPCCarry, MPCOutput, index_tensor, tree_map
from ..ops import admm
from ..qp import condensed
from ..qp import mpc as vs_mpc

N_STAGES = 4


class _Payload(NamedTuple):
    """The stage products that cross an edge (None until produced)."""

    carry: MPCCarry
    prep: vs_mpc.TickPrep = None                # S0
    qp: condensed.CondensedQP = None            # S1 (F/f slim)
    csol: condensed.CondensedSolution = None    # S2 (kinv/ρ in the carry)
    out: MPCOutput = None                       # S3


def _stages(cfg: MPCConfig, sched, joint_sel, settings, problem):
    slim = not cfg.enable_debug_log_mode

    def s0_prep(p: _Payload, snap, est) -> _Payload:
        carry, prep = vs_mpc._tick_prep(cfg, joint_sel, problem, p.carry,
                                        snap, est)
        return p._replace(carry=carry, prep=prep)

    def s1_condense(p: _Payload, snap, est) -> _Payload:
        qp = vs_mpc.condense_from_prep(cfg, sched, joint_sel, problem,
                                       p.carry, p.prep)[0]
        if slim:
            # the solve only reads states at knots (0, -1); the H/q fold
            # consumed the full F above — don't ship 17 knots on
            keep = index_tensor((0, cfg.n_iter - 1), qp.F.device)
            qp = qp._replace(F=qp.F[:, keep], f=qp.f[:, keep])
        return p._replace(qp=qp)

    def s2_solve(p: _Payload, snap, est) -> _Payload:
        csol = vs_mpc.solve_condensed(cfg, settings, problem, p.carry, p.qp)
        carry = p.carry
        if settings.kinv_carry and csol.kinv is not None:
            # fold the refreshed solver state into the carry here so the
            # ring does not ship a second [nU, nU] matrix to S3
            carry = carry._replace(kinv=csol.kinv, rho_vec=csol.rho_vec,
                                   rho_scalar=csol.rho_scalar)
        if slim:
            csol = csol._replace(kinv=None, rho_vec=None, rho_scalar=None)
        return p._replace(carry=carry, csol=csol)

    def s3_extract(p: _Payload, snap, est) -> _Payload:
        # kinv was folded into the carry at S2: hand extract a csol whose
        # solver-state fields mirror the carry so its own fold is a no-op
        csol = p.csol
        if settings.kinv_carry and csol.kinv is None:
            csol = csol._replace(kinv=p.carry.kinv, rho_vec=p.carry.rho_vec,
                                 rho_scalar=p.carry.rho_scalar)
        carry, out = vs_mpc.extract_condensed(
            cfg, joint_sel, p.carry, csol, settings, problem=problem,
            sched=sched, prep=p.prep, qp=p.qp)
        return p._replace(carry=carry, out=out)

    return [s0_prep, s1_condense, s2_solve, s3_extract]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _on(stream):
    """``stream`` and its device current (the kernels launch on the current
    device's current stream); nothing on the CPU."""
    ctx = contextlib.ExitStack()
    if stream is not None:
        ctx.enter_context(torch.cuda.device(stream.device))
        ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _to(tree, device):
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


def _send(p: _Payload, src, dst, device):
    """The ``ppermute`` of one edge, issued on the sending stage's stream
    ``src``: the payload on ``device``, and the event the receiving stream
    ``dst`` waits on. A copy to another card is made on both stages'
    streams; a tensor that stays on its card is marked as in use by
    ``dst``, so the allocator does not hand its memory to ``src`` again
    before ``dst`` has read it."""
    if src is None:
        return _to(p, device), None
    with _on(dst):
        q = _to(p, device)
    tree_map(lambda a, b: b.record_stream(dst) if a is b else None, p, q)
    return q, src.record_event()


def pipeline_tick(cfg: MPCConfig, sched, joint_sel,
                  settings: admm.ADMMSettings, problem,
                  carries: MPCCarry, snaps, est, devices=None):
    """One MPC tick for a batch of scenarios, pipelined over ``devices``,
    the pipe axis: ``N_STAGES`` torch devices, stage i on ``devices[i]``
    (by default the inputs' device four times).

    ``carries``/``snaps``/``est`` are batched with leading dimension
    B = n_micro × micro, ``n_micro = N_STAGES``; the batch is cut into
    ``n_micro`` contiguous micro-batches that stream through the four
    stages in ``n_micro + N_STAGES − 1`` steps. Returns (carries',
    outputs) with the same leading dimension, on the inputs' device, equal
    lane for lane to ``mpc_tick`` with per-lane decisions."""
    if settings.batch_guard:
        raise ValueError(
            "pipeline_tick takes per-lane decisions only: its stages run "
            "each micro-batch on its own, where no batch-wide guard can "
            "range over the batch (JAX's vmap binds no axis name there); "
            "pass ADMMSettings(batch_guard=False)")
    if cfg.qp_solver != "condensed":
        raise ValueError("pipeline_tick pipelines the condensed tick; got "
                         f"qp_solver={cfg.qp_solver!r}")
    B = est.shape[0]
    if B % N_STAGES:
        raise ValueError(f"a batch of {B} does not cut into {N_STAGES} "
                         "micro-batches")
    home = _device(est.device)
    devices = [_device(d) for d in (devices or [home] * N_STAGES)]
    if len(devices) != N_STAGES:
        raise ValueError(f"pipeline_tick needs {N_STAGES} devices, got "
                         f"{len(devices)}")
    if len({d.type for d in devices + [home]}) != 1:
        raise ValueError(f"stages on {devices} for inputs on {home}: one "
                         "device type")
    problems = {d: _to(problem, d) for d in set(devices)}
    stages = [_stages(cfg, sched, joint_sel, settings, problems[d])[i]
              for i, d in enumerate(devices)]
    n_micro = N_STAGES
    micro = B // n_micro

    def micro_batch(tree, t):
        return tree_map(lambda a: a[t * micro:(t + 1) * micro], tree)

    streams = [None] * N_STAGES
    if home.type == "cuda":
        streams = [torch.cuda.Stream(device=d) for d in devices]
        for s, d in zip(streams, devices):
            s.wait_stream(torch.cuda.current_stream(d))
            s.wait_stream(torch.cuda.current_stream(home))

    # GPipe: at step t stage i works micro-batch t − i; the stages are
    # issued last first, so each takes its input before its producer
    # writes the next one
    inbox = [None] * N_STAGES
    results = []
    for t in range(n_micro + N_STAGES - 1):
        for i in reversed(range(N_STAGES)):
            mb = t - i
            if not 0 <= mb < n_micro:
                continue
            with _on(streams[i]):
                snap = est_mb = None
                if i == 0:
                    p = _Payload(carry=_to(micro_batch(carries, mb),
                                           devices[0]))
                    snap = _to(micro_batch(snaps, mb), devices[0])
                    est_mb = _to(micro_batch(est, mb), devices[0])
                else:
                    p, event = inbox[i]
                    if event is not None:
                        streams[i].wait_event(event)
                p = stages[i](p, snap, est_mb)
                if i + 1 < N_STAGES:
                    inbox[i + 1] = _send(p, streams[i], streams[i + 1],
                                         devices[i + 1])
                else:
                    results.append((p.carry, p.out))

    last = devices[-1]
    if home.type == "cuda":
        for s, d in zip(streams, devices):
            torch.cuda.current_stream(d).wait_stream(s)
            torch.cuda.current_stream(home).wait_stream(s)
        consumer = torch.cuda.current_stream(last)
        for part in (p for r in results for p in r):
            tree_map(lambda a: a.record_stream(consumer), part)

    def collect(*parts):
        return torch.cat(parts).to(home, non_blocking=True)

    carries_out = tree_map(collect, *[c for c, _ in results])
    outs = tree_map(collect, *[o for _, o in results])
    return carries_out, outs
