"""The float64 reference against the port on the CPU, on a whole pass of
each stream under each configuration, one perturbed lane.

The benchmark's check follows the program step by step (each tick from
the program's commands of the tick before). These tests check by
themselves the two things that leaves out:

- the start: the first tick from ``configure``'s carry, which set-up runs
  as the lead-in, at converged settings (400 iterations; at the
  configuration's 40 it ends SOLVED_INACCURATE on the takeoff stream and
  MAX_ITER on the airborne one, PERF.md §7), against the reference's own
  first tick;
- the chain: the port's commands over a pass from the lead-in's state
  against the reference chained on its own solutions.

Both at the recorded streams' tolerances of tests/test_command_fidelity.py
(2e-3 rad, 0.15 % throttle, 0.5 N, 2 N/s). The step-by-step reference is
held to the cell's own limits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpcbench.core import check, port, spec, traffic
from mpcbench.reference import chain

TOL = dict(joints_pos_ref=2e-3, throttle=0.15, thrust_des=0.5,
           thrust_dot_des=2.0)
JITTER = np.array([0.05, -0.1, 0.02, 0.0, 0.03, -0.04], np.float32)
CELL = {"mk3_paper": "mk3_paper.robot_b1"}


def controller(config, **solver):
    cfg = spec.config(spec.benchmark(), config)
    cfg["solver"].update(solver)
    return port.build(cfg, traffic.load(spec.traffic_path("robot_b1")))


def port_pass(ctl, stream, n):
    st = port.load_stream(spec.stream_path(stream), "cpu")
    jt = torch.as_tensor(JITTER[None])
    problem, carry = port.configure(ctl, st, 1, "cpu")
    outs = []
    for t in range(n):
        carry, out = port.tick(ctl, problem, carry,
                               *port.snapshot(st, t, 1, jt))
        outs.append(out)
    return outs


def outputs(out):
    return {k: getattr(out, k)[0].numpy().astype(np.float64)
            for k in chain.OUTPUTS}


CASES = [(c, s) for c in CELL for s in ("takeoff", "airborne")]


@pytest.mark.parametrize("config,stream", CASES)
def test_start_at_converged_settings(config, stream):
    out = outputs(port_pass(controller(config, max_iter=400), stream, 1)[0])
    ref = chain.run_lane(spec.config_path(spec.benchmark(), config),
                         spec.stream_path(stream), JITTER, 0, None, 1)
    for k, tol in TOL.items():
        assert np.abs(out[k] - ref[k][0]).max() <= tol, k


@pytest.mark.parametrize("config,stream", CASES)
def test_pass_chained_and_step_by_step(config, stream):
    n = 120
    outs = port_pass(controller(config), stream, n)
    rows = [outputs(o) for o in outs]
    assert all(int(o.status[0]) in (1, 2) for o in outs[1:])
    path = spec.config_path(spec.benchmark(), config)
    ref = chain.run_lane(path, spec.stream_path(stream), JITTER, 1, rows[0],
                         n - 1)
    for k, tol in TOL.items():
        got = np.stack([r[k] for r in rows[1:]])
        assert np.abs(got - ref[k]).max() <= tol, k
    steps = chain.step_lane(path, spec.stream_path(stream), JITTER,
                            [(t, rows[t - 1]) for t in range(1, n)])
    limits = spec.cell(CELL[config])["limits"]
    for name, (k, part) in check.GROUPS.items():
        if name in limits:
            gap = max(np.abs(rows[t][k][part] - steps[t - 1][k][part]).max()
                      for t in range(1, n))
            assert gap <= limits[name], name
