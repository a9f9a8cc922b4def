"""The pipelined tick on a card: four stages on four CUDA streams of one
device against the monolithic tick on the same card.

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_parallel_gpu.py``. Without
a card the tests skip (marker ``gpu``); chip_smoke.py's ``parallel`` phase
makes the same checks at batch 256 over 20 ticks.

Tolerances are those of the batch-1 tick against JAX
(``tests/test_torch_tick.py``; joints 1e-4, throttle 1e-3 %, thrust_des
1e-3, final_state 2e-5 of its largest entry): the pipeline runs each lane
as the monolithic tick does, but on micro-batches of B/4, where a batched
library call may pick another algorithm than at B and round otherwise. For
the same reason a lane may close SOLVED on one side and SOLVED_INACCURATE on
the other only where its residuals agree within 10×, the width of the
solver's own inaccurate band (the rule of tests/test_torch_sweep.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch.core.types import expand_lanes
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
from ironcub_mpc_tpu_torch.ops import admm, kernels
from ironcub_mpc_tpu_torch.parallel import N_STAGES, pipeline_tick
from ironcub_mpc_tpu_torch.qp import condensed, mpc
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

TOL = dict(joints_pos_ref=1e-4, throttle=1e-3, thrust_des=1e-3,
           final_state=2e-5)
BENCH = dict(max_iter=40, polish=True, rho_update_iters=(15,),
             kinv_guard=True, ns_skip_tol=0.02, term_check_every=5)
FLIP_FACTOR = 10.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: chip_smoke.py's parallel phase "
                    "runs these on the card")
    kernels.build()
    return torch.device("cuda")


def _chain(replay, settings, batch, n_ticks, pipelined, jitter):
    problem, carry = replay.configure(settings)
    c = expand_lanes(carry, batch)
    outs = []
    for t in range(n_ticks):
        snap, est = replay.tick_inputs(t, batch, jitter)
        args = (replay.cfg, replay.sched, replay.sel, settings, problem, c,
                snap, est)
        c, out = (pipeline_tick(*args, devices=[snap.w_R_b.device]
                                * N_STAGES) if pipelined
                  else mpc.mpc_tick(*args))
        outs.append(out)
    torch.cuda.synchronize()
    return c, outs


def _hold(got, want, what):
    ok = got.status == want.status
    flip = ~ok
    if bool(flip.any()):
        pair = {int(got.status[flip].min()), int(got.status[flip].max()),
                int(want.status[flip].min()), int(want.status[flip].max())}
        assert pair <= {admm.SOLVED, admm.SOLVED_INACCURATE}, (what, pair)
        for f in ("pri_res", "dua_res"):
            a, b = getattr(got, f)[flip], getattr(want, f)[flip]
            assert bool((torch.maximum(a, b)
                         <= FLIP_FACTOR * torch.minimum(a, b)).all()), (
                what, f, a, b)
    for k, tol in TOL.items():
        a = getattr(got, k)[ok].double().cpu().numpy()
        b = getattr(want, k)[ok].double().cpu().numpy()
        err = np.abs(a - b).max(initial=0.0)
        if k == "final_state":
            err /= max(np.abs(b).max(initial=0.0), 1.0)
        assert err <= tol, (what, k, err)


@pytest.mark.gpu
def test_pipeline_on_card_matches_monolithic(card):
    """Five chained ticks of the recorded stream at batch 64, the kernels
    launched inside the pipelined ticks, no host read-back."""
    replay = load_flight_replay(device=card)
    settings = admm.ADMMSettings(**BENCH)
    jitter = torch.as_tensor((0.1 * np.random.default_rng(0).standard_normal(
        (64, 6))).astype(np.float32), device=card)
    _, mono = _chain(replay, settings, 64, 5, False, jitter)
    kernels.reset_launches()
    condensed.batch_any.syncs = 0
    carry, pipe = _chain(replay, settings, 64, 5, True, jitter)
    assert kernels.admm_segment.launches > 0
    assert kernels.woodbury_ns.launches > 0
    assert condensed.batch_any.syncs == 0
    assert carry.kinv.device.type == "cuda" and carry.kinv.shape[0] == 64
    for t, (p, m) in enumerate(zip(pipe, mono)):
        assert bool(((p.status == admm.SOLVED)
                     | (p.status == admm.SOLVED_INACCURATE)).all())
        _hold(p, m, f"tick {t}")


@pytest.mark.gpu
def test_pipeline_debug_log_on_card(card):
    r = load_flight_replay(device=card)
    cfg = dataclasses.replace(r.cfg, enable_debug_log_mode=True)
    replay = r._replace(cfg=cfg, sched=build_schedule(cfg))
    settings = admm.ADMMSettings(**BENCH)
    _, mono = _chain(replay, settings, 8, 2, False, None)
    _, pipe = _chain(replay, settings, 8, 2, True, None)
    for t, (p, m) in enumerate(zip(pipe, mono)):
        _hold(p, m, f"debug tick {t}")
        for f in p.debug._fields:
            a = getattr(p.debug, f).double().cpu().numpy()
            b = getattr(m.debug, f).double().cpu().numpy()
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
            assert err <= 1e-4, (t, f, err)
