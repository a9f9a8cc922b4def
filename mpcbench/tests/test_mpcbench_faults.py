"""Runs of the harness with the timed path broken underneath: the check
reads `correct` false. The harness's look for a card is skipped (the
driver runs on the CPU through the kernels' plain twins); the rest of a
run is the benchmark's own. The faults a cell of this benchmark can have:
a tick that returns its state unchanged, half of the batch left out (its
lanes given the mean of the rest), and a command altered where it is
produced. No cell runs across chips, so there is no exchange to leave out.
"""

import pytest
import torch

from mpcbench.calibrate import CONTROLS
from mpcbench.core import driver, port

from test_mpcbench_cells import CELLS, tiny

REAL_TICK = port.tick


def unchanged(ctl, problem, carry, snap, est):
    _, out = REAL_TICK(ctl, problem, carry, snap, est)
    return carry, out._replace(
        joints_pos_ref=carry.joints_pos_ref, throttle=carry.throttle_cmd,
        thrust_des=carry.thrust_des, thrust_dot_des=carry.thrust_dot_des)


def half_batch(ctl, problem, carry, snap, est):
    carry, out = REAL_TICK(ctl, problem, carry, snap, est)
    h = out.joints_pos_ref.shape[0] // 2

    def fill(t):
        t = t.clone()
        t[h:] = t[:h].mean(dim=0)
        return t
    return carry, out._replace(
        joints_pos_ref=fill(out.joints_pos_ref), throttle=fill(out.throttle),
        thrust_des=fill(out.thrust_des),
        thrust_dot_des=fill(out.thrust_dot_des))


def altered(ctl, problem, carry, snap, est):
    carry, out = REAL_TICK(ctl, problem, carry, snap, est)
    return carry, out._replace(throttle=out.throttle + 1.0)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


def run(name, monkeypatch, fault=None):
    over = tiny(name)
    if fault is half_batch:
        over.update(lanes=4, check_lanes=4)
    if fault is not None:
        monkeypatch.setattr(port, "tick", fault)
    return driver.run(name, 2 ** 31 + 21, 1.0, False, device="cpu",
                      overrides=over)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_reads_incorrect(name, fault, monkeypatch):
    res = run(name, monkeypatch, FAULTS[fault])
    assert not res["correct"]
    over = [k for k, v in res["check"].items()
            if v["limit"] is not None and v["value"] > v["limit"]]
    assert over, res["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", list(CONTROLS))
def test_control_reads_incorrect(name, control, cuda_device):
    """Each control on the card, at the cell's own size and load with a
    short window, on three seeds: the program with a precision lowered
    (PyTorch's TF32 switch, TF32 in every product, the kernels' inputs and
    outputs in bfloat16) fails the check that the program as configured
    passes."""
    for seed in (2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33):
        with CONTROLS[control](torch):
            res = driver.run(name, seed, 6.0, False, device=cuda_device,
                             overrides=dict(warm_passes=0))
        assert not res["correct"], (seed, res["check"])
    res = driver.run(name, 2 ** 31 + 34, 6.0, False, device=cuda_device,
                     overrides=dict(warm_passes=0))
    assert res["correct"], res["check"]
