"""Bounded regression of the port's reference flight on the CPU.

The port's counterpart of ``tests/test_flight_regression.py``, at its
bounds: the first 20 s of the converted reference mission (standing, the
early alphaGravity ramp and the takeoff at ~16.6 s) through the port's
closed loop (plant, LSTM+EKF jets, multi-rate MPC; ``runtime/flight.py``)
on the CPU, batch 1. Every tick solved and finite; CoM RMSE < 0.06 m and max
< 0.15 m; RPY RMSE < 2° and max < 6°; takeoff between 10 and 20 s and CoM
RMSE after it < 0.09 m. The card flies the same slice in ``chip_smoke.py``'s
flight phase. Marked ``slow``: 4,000 eager ticks take minutes on the CPU.
"""

import pytest

from test_torch_tick import one_torch_thread  # noqa: F401

from ironcub_mpc_tpu_torch.core.types import tree_map
from ironcub_mpc_tpu_torch.runtime import flight

SECONDS = 20.0

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_torch_thread")]


@pytest.fixture(scope="module")
def flight_slice(one_torch_thread):  # noqa: F811
    loop, pos_traj, alpha_traj = flight.build_flight_loop(device="cpu")
    tel, info = flight.run_flight(SECONDS, loop=loop, pos_traj=pos_traj,
                                  alpha_traj=alpha_traj)
    lane = tree_map(lambda v: v[:, 0].numpy(), tel)
    stats = flight.flight_stats(lane, loop.cfg.period_mpc,
                                total_mass=loop.kd.model.total_mass)
    return tel, info, stats


def test_flight_slice_solves_every_tick(flight_slice):
    _, _, stats = flight_slice
    assert stats["finite"]
    assert stats["n_not_solved"] == 0, stats
    assert stats["ticks"] == int(SECONDS / 0.005)


def test_flight_slice_tracking_bounds(flight_slice):
    _, _, stats = flight_slice
    assert stats["com_rmse_m"] < 0.06, stats
    assert stats["com_max_m"] < 0.15, stats
    assert stats["rpy_rmse_deg"] < 2.0, stats
    assert stats["rpy_max_deg"] < 6.0, stats


def test_flight_slice_takes_off_on_schedule(flight_slice):
    _, _, stats = flight_slice
    assert "takeoff_t_s" in stats, "never became airborne in 20 s"
    assert 10.0 < stats["takeoff_t_s"] < 20.0, stats
    assert stats["com_rmse_post_takeoff_m"] < 0.09, stats
