"""The port's command sequence against the float64 oracle on the recorded
flight streams, and the bench solver against a deep solve.

The mirror of the recorded half of ``tests/test_command_fidelity.py``:

- the ``ramp`` (``tests/golden/flight_snapshots.npz``, mid-takeoff on the
  alphaGravity ramp) and ``airborne`` (``flight_snapshots_air.npz``)
  streams, 120 ticks each under the flight configuration, replayed through
  the port's tick (``max_iter=400``, polish) beside
  ``golden_oracle.OracleMPC``; held at the JAX test's tolerances: joints
  2e-3 rad, throttle 0.15 %, the same throttle-update ticks at 1e-3 and at
  least 5 of them, thrust_des 0.5 N, thrust_dot_des 2.0 N/s;
- the bench configuration (``bench.py``'s ``max_iter=40``, ρ mark at 15,
  the probe gate, the early exit) on the port's batch-2 tick with
  batch-wide decisions, lane 0 against a 400-iteration batch-1 solve over
  45 recorded ticks: throttle 0.2 %, joints 2e-3 rad, thrust 0.5 N.

The port runs on the CPU in float32 with ``kernel_mode="off"`` (the plain
twins of the CUDA kernels).
"""

from pathlib import Path

import numpy as np
import pytest

from oracle_replay import assert_solved, oracle_frames, replay_against_oracle
from test_command_fidelity import N_REC, _series
from test_torch_tick import one_torch_thread  # noqa: F401

from ironcub_mpc_tpu_torch.core.types import expand_lanes
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.qp import mpc
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = Path(__file__).parent / "golden"
STREAMS = {"ramp": "flight_snapshots.npz",
           "airborne": "flight_snapshots_air.npz"}
# bench.py:84-89
BENCH = dict(max_iter=40, polish=True, rho_update_iters=(15,),
             kinv_guard=True, ns_skip_tol=0.02, term_check_every=5)


@pytest.fixture(scope="module", params=list(STREAMS))
def recorded_sequences(request):
    path = GOLDEN / STREAMS[request.param]
    replay = load_flight_replay(path, device="cpu")
    settings = admm.ADMMSettings(max_iter=400, polish=True,
                                 kernel_mode="off")
    return replay_against_oracle(replay, oracle_frames(path), settings,
                                 N_REC)


def test_recorded_flight_joint_commands(recorded_sequences):
    port, orc = recorded_sequences
    np.testing.assert_allclose(_series(port, "joints_pos_ref"),
                               _series(orc, "joints_pos_ref"), atol=2e-3)


def test_recorded_flight_throttle_commands(recorded_sequences):
    port, orc = recorded_sequences
    port_t, orc_t = _series(port, "throttle"), _series(orc, "throttle")
    np.testing.assert_allclose(port_t, orc_t, atol=0.15)
    # the multi-rate boundaries: a real 10 Hz update moves throttle by
    # 0.1-1 %; 1e-3 rejects solver noise on knots held at a throttle bound
    port_changes = np.any(np.abs(np.diff(port_t, axis=0)) > 1e-3, axis=1)
    orc_changes = np.any(np.abs(np.diff(orc_t, axis=0)) > 1e-3, axis=1)
    np.testing.assert_array_equal(port_changes, orc_changes)
    # the stream spans several multi-rate boundaries
    assert port_changes.sum() >= 5


def test_recorded_flight_thrust_commands(recorded_sequences):
    port, orc = recorded_sequences
    np.testing.assert_allclose(_series(port, "thrust_des"),
                               _series(orc, "thrust_des"), atol=0.5)
    np.testing.assert_allclose(_series(port, "thrust_dot_des"),
                               _series(orc, "thrust_dot_des"), atol=2.0)


def test_bench_solver_config_fidelity_on_recorded_stream():
    """The benched solver keeps command fidelity against a 400-iteration
    solve over 45 recorded ticks (two 20-tick multi-rate boundaries): lane 0
    of the batch-2 tick with batch-wide decisions against the batch-1 deep
    tick, every lane solved."""
    replay = load_flight_replay(device="cpu")
    n = 45
    bench = admm.ADMMSettings(**BENCH, batch_guard=True, kernel_mode="off")
    deep = admm.ADMMSettings(max_iter=400, polish=True, kernel_mode="off")

    def run(settings, batch):
        problem, carry = replay.configure(settings)
        carry = expand_lanes(carry, batch)
        outs = []
        for t in range(n):
            snap, est = replay.tick_inputs(t, batch)
            carry, out = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel,
                                      settings, problem, carry, snap, est)
            outs.append(out)
        return outs

    for t, (b, d) in enumerate(zip(run(bench, 2), run(deep, 1))):
        assert_solved(b, f"bench tick {t}")
        np.testing.assert_allclose(
            b.throttle[0].numpy(), d.throttle[0].numpy(), atol=0.2,
            err_msg=f"throttle diverges at tick {t}")
        np.testing.assert_allclose(
            b.joints_pos_ref[0].numpy(), d.joints_pos_ref[0].numpy(),
            atol=2e-3, err_msg=f"joints diverge at tick {t}")
        np.testing.assert_allclose(
            b.thrust_des[0].numpy(), d.thrust_des[0].numpy(), atol=0.5,
            err_msg=f"thrust diverges at tick {t}")
