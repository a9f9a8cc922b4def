"""The port's closed loop on a card: the tick launches both kernels, waits
for the device nowhere, and agrees with the CPU run (the plain twins).

Imports no JAX, so it runs on a CUDA machine that has only the port:
``python -m pytest --noconftest tests/test_torch_flight_gpu.py``. Without a
card the tests skip (marker ``gpu``); chip_smoke.py makes the same checks
over a longer flight.
"""

import numpy as np
import pytest
import torch

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.qp import condensed, mpc
from ironcub_mpc_tpu_torch.runtime import flight
from ironcub_mpc_tpu_torch.runtime.loop import run_snapshot

N_TICKS = 10


@pytest.fixture(scope="module")
def loops():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the closed loop's kernels run only "
                    "on the card (chip_smoke.py flies it there)")
    kernels.build()
    out = {}
    settled = None
    for dev in ("cuda", "cpu"):
        loop, pos, alpha = flight.build_flight_loop(device=dev)
        if settled is None:
            settled = loop.settle(flight.standing_state(
                loop.plant, loop.plant.sim_cfg.initial_position_deg), 0.2)
        # both loops start from the state settled on the card
        problem, carry = loop.configure(convert.to_device(settled, dev),
                                        *flight.mission_inputs(pos, alpha))
        out[dev] = (loop, problem, carry)
    return out


@pytest.mark.gpu
def test_closed_loop_on_card_matches_cpu_and_launches_kernels(loops):
    loop, problem, carry = loops["cuda"]
    kernels.reset_launches()
    _, tel = loop.rollout(problem, carry, N_TICKS)
    torch.cuda.synchronize()
    assert kernels.admm_segment.launches >= N_TICKS
    assert kernels.woodbury_ns.launches >= N_TICKS
    loop_c, problem_c, carry_c = loops["cpu"]
    _, tel_c = loop_c.rollout(problem_c, carry_c, N_TICKS)
    assert torch.equal(tel.solver_status.cpu(), tel_c.solver_status)
    # from the same settled state: float32 rounding through the solver, the
    # tolerances of the CPU test against JAX (tests/test_torch_loop.py)
    np.testing.assert_allclose(tel.com_position.cpu().numpy(),
                               tel_c.com_position.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tel.throttle.cpu().numpy(),
                               tel_c.throttle.numpy(), rtol=0, atol=0.1)


@pytest.mark.gpu
def test_tick_never_waits_for_the_device(loops):
    """With per-lane decisions a tick reads nothing back and copies nothing
    from the host: any synchronising call raises under the debug mode. The
    snapshot and the MPC tick are replays of their CUDA graphs."""
    loop, problem, carry = loops["cuda"]
    carry, _ = loop.tick(problem, carry)              # constants are cached
    condensed.batch_any.syncs = 0
    graphed = mpc.mpc_tick.graphed_ticks
    snapshots = run_snapshot.graphed_snapshots
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, tel = loop.tick(problem, carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert condensed.batch_any.syncs == 0
    assert mpc.mpc_tick.graphed_ticks == graphed + 1
    assert run_snapshot.graphed_snapshots == snapshots + 1
    assert int(tel.solver_status[0]) in (1, 2)
