"""The port's full-space tick, debug-log mode and condense modes on a card,
against the port's CPU run.

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_full_gpu.py``. Without a
card the tests skip (marker ``gpu``); chip_smoke.py's ``full_space`` phase
makes the same checks at batch 64 and 256.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.types import expand_lanes
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
from ironcub_mpc_tpu_torch.ops import admm, kernels
from ironcub_mpc_tpu_torch.qp import condensed, mpc
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

N_TICKS = 3
# the tolerances of tests/test_torch_full.py against JAX
TOL = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
           final_state=2e-5)


def _replay(device, **over):
    r = load_flight_replay(device=device)
    cfg = dataclasses.replace(r.cfg, **over)
    return r._replace(cfg=cfg, sched=build_schedule(cfg))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: chip_smoke.py's full_space phase "
                    "runs these on the card")
    kernels.build()
    return torch.device("cuda")


def _run(replay, settings, batch, n, jitter=None):
    problem, carry = replay.configure(settings)
    c = expand_lanes(carry, batch)
    jit = None if jitter is None else torch.as_tensor(
        jitter, device=replay.est_td.device)
    outs = []
    for t in range(n):
        c, out = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel, settings,
                              problem, c, *replay.tick_inputs(t, batch, jit))
        outs.append(out)
    return c, outs


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
def test_full_tick_on_card_matches_cpu(card, batch):
    jitter = None if batch == 1 else (
        0.1 * np.random.default_rng(0).standard_normal((batch, 6))
    ).astype(np.float32)
    settings = admm.ADMMSettings()
    kernels.reset_launches()
    _, gpu = _run(_replay(card, qp_solver="full"), settings, batch, N_TICKS,
                  jitter)
    torch.cuda.synchronize()
    # no hand-written kernel is on the full-space path
    assert kernels.admm_segment.launches == kernels.woodbury_ns.launches == 0
    _, cpu = _run(_replay("cpu", qp_solver="full"), settings, batch, N_TICKS,
                  jitter)
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        assert torch.equal(g.status.cpu(), c.status), t
        assert bool(((c.status == 1) | (c.status == 2)).all()), t
        for name, tol in TOL.items():
            a, b = getattr(g, name).cpu().numpy(), getattr(c, name).numpy()
            err = np.abs(a - b).max()
            if name == "final_state":
                err /= max(np.abs(b).max(), 1.0)
            assert err <= tol, (t, name, err)


@pytest.mark.gpu
def test_full_tick_never_waits_for_the_device(card):
    """The batch-1 full tick reads nothing back and copies nothing from the
    host: any synchronising call raises under the debug mode."""
    replay = _replay(card, qp_solver="full")
    settings = admm.ADMMSettings()
    problem, carry = replay.configure(settings)
    inputs = replay.tick_inputs(0)
    carry, _ = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel, settings,
                            problem, carry, *inputs)       # constants cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, out = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel,
                                  settings, problem, carry,
                                  *replay.tick_inputs(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(out.status[0]) in (1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["condensed", "full"])
def test_debug_log_on_card_matches_cpu(card, solver):
    over = dict(qp_solver=solver, enable_debug_log_mode=True)
    settings = admm.ADMMSettings(max_iter=120)
    kernels.reset_launches()
    _, gpu = _run(_replay(card, **over), settings, 1, 2)
    torch.cuda.synchronize()
    if solver == "condensed":
        assert kernels.admm_segment.launches > 0
        assert kernels.woodbury_ns.launches > 0
    _, cpu = _run(_replay("cpu", **over), settings, 1, 2)
    for g, c in zip(gpu, cpu):
        for name, a, b in zip(g.debug._fields, g.debug, c.debug):
            a, b = a.cpu().double().numpy(), b.double().numpy()
            assert np.isfinite(a).all(), name
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
            assert err < 1e-4, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["assoc", "structured", "paired"])
def test_condense_mode_on_card_matches_sequential(card, mode):
    replay = _replay(card)
    problem, carry = replay.configure(admm.ADMMSettings())
    carry, prep = mpc._tick_prep(replay.cfg, replay.sel, problem, carry,
                                 *replay.tick_inputs(0))
    out = {}
    for m in ("sequential", mode):
        cfg = dataclasses.replace(replay.cfg, condense_mode=m)
        out[m] = mpc.condense_from_prep(cfg, replay.sched, replay.sel,
                                        problem, carry, prep)[0]
    a, b = out[mode], out["sequential"]
    f_scale = max(float(b.f.abs().max()), 1.0)
    for name, tol in (("F", 5e-5), ("f", 5e-5 * f_scale),
                      ("H", 2e-5 * float(b.H.abs().max())),
                      ("q", 2e-5 * float(b.q.abs().max()))):
        err = float((getattr(a, name) - getattr(b, name)).abs().max())
        assert err <= tol, (name, err, tol)
    assert torch.equal(a.lb, b.lb) and torch.equal(a.ub, b.ub)
    assert condensed.n_inputs(replay.cfg) == a.H.shape[-1]
