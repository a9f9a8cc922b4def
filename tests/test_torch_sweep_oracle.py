"""The port's Monte-Carlo sweep against the plain float64 reference
``tests/sweep_oracle.py`` on the CPU: ``parallel/monte_carlo.py``
``run_sweep`` over the flight's closed loop (``runtime/flight.py``
``build_flight_loop``, the kernels' plain path) at 4 lanes × 10 ticks
from the recorded airborne branch (mission tick 4400), each lane perturbed
by ``make_batched_carry`` (5 N wind, 5 % turbine mismatch, initial
base-velocity and posture noise), batch-wide decisions, the retry on.

Step by step, each tick of each lane from the program's plant state and
its commands of the tick before under the lane's wind and thrust scale:
the snapshot's CoM and momentum, the controller's CoM reference, the
commands and the plant state after the tick. Then the statistics: the
program's per-lane largest CoM error against the reference's over its own
snapshots and references, and every count of ``SweepResult`` against the
reference's reduction of the recorded statuses and the program's per-lane
vectors. A retry is forced on one lane-tick (its first solve marked failed
and its commands spoilt), so the retried lane-tick is checked too.

Each tolerance is stated with its reason, tied to
``tests/test_torch_flight_oracle.py``'s. Each fault (the plant dropping
the thrust scale, two lanes' perturbations swapped, the retry's result not
picked) must fail a number. The benchmark's copy of the reference
(``mpcbench/reference/sweep.py``) is this reference below its first line.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import sweep_oracle as so

from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.parallel import monte_carlo
from ironcub_mpc_tpu_torch.parallel import (ScenarioConfig,
                                            make_batched_carry, run_sweep)
from ironcub_mpc_tpu_torch.runtime import checkpoint, flight
from ironcub_mpc_tpu_torch.sim.plant import Plant

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "mpcbench" / "configs" / "mk3_sweep.json"
FLIGHT_CONFIG = ROOT / "mpcbench" / "configs" / "mk3_flight.json"
STREAMS = ROOT / "mpcbench" / "streams"
START, BRANCH = STREAMS / "flight_start.npz", STREAMS / "flight_airborne.npz"
N_LANES, N_TICKS, SEED = 4, 10, 2 ** 31 + 5
# the forced retry: lane FORCED_LANE's first solve of tick FORCED_TICK
FORCED_TICK, FORCED_LANE = 4, 2

# One tick from the program's own state and commands of the tick before,
# each a float32 rounding budget with room, as in
# test_torch_flight_oracle.py: the snapshot's CoM and Jacobian-made
# quantities 2e-6 m and its momentum 2e-5 (test_snapshot_and_mass_matrix_
# match_reference); the commands are ADMM's at eps 1e-4 against the exact
# solve, within test_five_ticks_from_a_recorded_start's bounds (joint steps
# 2e-4 rad, throttle 0.02 %, thrust 2e-3 N, its rate 0.1 N/s); the state
# after the tick's five substeps, the substep budget (SUBSTEP_TOL) five
# times: positions 5e-6, base velocity 1e-4, joint velocity 5e-4, the jets
# 1e-3 N. The CoM reference is the trajectory's float32 samples in both:
# 1e-6 m.
STEP_TOL = dict(com=2e-6, momentum=2e-5, com_ref=1e-6, joints_pos_ref=2e-4,
                throttle=0.02, thrust_des=2e-3, thrust_dot_des=0.1,
                base_p=5e-6, base_R=5e-6, q=5e-6, base_v=1e-4, qd=5e-4,
                thrust_nn=1e-3, ekf_x=1e-3)
# a lane's largest CoM error: the snapshot's CoM budget (2e-6 m) and the
# reference's (1e-6 m), with room
MAX_ERR_TOL = 5e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager PyTorch on one thread: several test processes share the
    cores, and a thread a core makes each small op wait."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def arrays(path, prefix) -> dict:
    z = np.load(path)
    return {k: torch.as_tensor(z[k]) for k in z.files
            if k.startswith(prefix + ".")}


@pytest.fixture(scope="module")
def setup():
    """The flight loop on the CPU at the sweep's settings (the kernels'
    plain path), its problem configured on the settled start, the
    scenario, and the branch's carry perturbed for every lane."""
    config = json.loads(CONFIG.read_text())
    loop, pos, alpha = flight.build_flight_loop(device="cpu")
    loop.settings = dataclasses.replace(loop.settings, kernel_mode="off",
                                        batch_guard=True)
    settled = checkpoint.unflatten(
        arrays(START, "plant"), "plant",
        flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg))
    problem, one = loop.configure(settled, *flight.mission_inputs(pos, alpha))
    carry = checkpoint.unflatten(arrays(BRANCH, "carry"), "carry", one)
    sc = config["scenario"]
    scen = ScenarioConfig(
        wind_force_std=5.0, thrust_scale_std=sc["thrust_scale_std"],
        base_vel_std=sc["base_vel_std"], joint_pos_std=sc["joint_pos_std"],
        com_err_fail=sc["com_err_fail_m"],
        mass_scale_std=sc["mass_scale_std"],
        jet_pos_std_m=sc["jet_pos_std_m"])
    batched = make_batched_carry(carry, N_LANES, scen, seed=SEED)
    return loop, problem, scen, batched


def forced_retry(loop, monkeypatch, at=FORCED_TICK, lane=FORCED_LANE):
    """Lane ``lane``'s first solve of tick ``at`` (from 0) reads failed
    (the iteration cap) with its throttle 5 % off, as a bad solve's
    commands: the retry must replace them. Made on the device by masks,
    so the fault itself reads nothing back."""
    real = loop.tick
    count = [0]

    def tick(problem, carry, settings=None):
        new, tel = real(problem, carry, settings)
        if settings is None:
            count[0] += 1
            if count[0] == at + 1:
                st = tel.solver_status
                hit = torch.arange(st.shape[0], device=st.device) == lane
                status = torch.where(
                    hit, torch.full_like(st, admm.MAX_ITER_REACHED), st)
                throttle = torch.where(hit[:, None], tel.throttle + 5.0,
                                       tel.throttle)
                tel = tel._replace(solver_status=status, throttle=throttle)
        return new, tel

    monkeypatch.setattr(loop, "tick", tick)


def sweep(setup, batched=None):
    """(result, [(telemetry, plant state after)] a tick) of the sweep."""
    loop, problem, scen, start = setup
    ticks = []
    res = run_sweep(loop, problem, start if batched is None else batched,
                    N_TICKS, scen=scen, recover=True,
                    on_tick=lambda tel, carry: ticks.append(
                        (tel, carry.plant)))
    return res, ticks


def state(p, lane) -> dict:
    """Lane ``lane`` of a port plant state as the reference's fields."""
    return dict(base_R=p.base_R[lane], base_p=p.base_p[lane],
                base_v=p.base_v[lane], q=p.q[lane], qd=p.qd[lane],
                thrust_nn=p.thrust_nn[lane], ekf_x=p.ekf.x[lane],
                ekf_P=p.ekf.P[lane], throttle=p.throttle[lane],
                q_des=p.q_des[lane])


def host(d: dict) -> dict:
    return {k: v.double().numpy() for k, v in d.items()}


def commands(tel, lane) -> dict:
    return host(dict(joints_pos_ref=tel.joints_pos_ref[lane],
                     throttle=tel.throttle[lane],
                     thrust_des=tel.thrust_desired[lane],
                     thrust_dot_des=tel.thrust_desired_dot[lane]))


def lane_of(batched, lane) -> dict:
    p = batched.plant
    return host(dict(wind=p.wind_force[lane],
                     thrust_scale=p.thrust_scale[lane],
                     mass_scale=p.mass_scale[lane],
                     jet_pos_offset=p.jet_pos_offset[lane]))


def references(setup, ticks) -> list:
    """The reference beside every tick of every lane: [lane][tick]
    {observed, commands, next}."""
    _, _, _, start = setup
    m = start.mpc
    first = host(dict(joints_pos_ref=m.joints_pos_ref,
                      throttle=m.throttle_cmd, thrust_des=m.thrust_des,
                      thrust_dot_des=m.thrust_dot_des))
    out = []
    for lane in range(N_LANES):
        todo = []
        for t, (tel, _) in enumerate(ticks):
            before = start.plant if t == 0 else ticks[t - 1][1]
            prev = ({k: v[lane] for k, v in first.items()} if t == 0
                    else commands(ticks[t - 1][0], lane))
            todo.append((True, host(state(before, lane)), prev,
                         commands(tel, lane)))
        out.append(so.step_pass(CONFIG, START, BRANCH,
                                lane_of(start, lane), todo))
    return out


def step_gaps(ticks, refs) -> dict:
    """The largest gap of each compared quantity over lanes and ticks."""
    worst = dict.fromkeys(STEP_TOL, 0.0)
    for lane, per_tick in enumerate(refs):
        for (tel, p), ref in zip(ticks, per_tick):
            got = dict(com=tel.com_position[lane],
                       momentum=torch.cat((tel.linear_momentum[lane],
                                           tel.angular_momentum[lane])),
                       com_ref=tel.com_position_desired[lane])
            # the state's throttle is the tick's command, compared once
            got = {**host(got), **host(state(p, lane)),
                   **commands(tel, lane)}
            want = {**ref["observed"], **ref["next"], **ref["commands"]}
            for k in STEP_TOL:
                gap = np.abs(np.asarray(got[k]).reshape(-1)
                             - np.asarray(want[k]).reshape(-1)).max()
                worst[k] = max(worst[k], float(gap))
    return worst


def over(gaps: dict) -> dict:
    return {k: (v, STEP_TOL[k]) for k, v in gaps.items() if v > STEP_TOL[k]}


def statistics_gaps(res, ticks, refs, scen) -> dict:
    """The program's statistics against the reference's: the per-lane
    largest CoM error from the reference's own snapshots and CoM
    references; the counts from the recorded statuses and guard firings
    and the program's per-lane vectors."""
    com = np.stack([[r["observed"]["com"] for r in per] for per in refs], 1)
    ref_ = np.stack([[r["observed"]["com_ref"] for r in per]
                     for per in refs], 1)
    status = torch.stack([tel.solver_status for tel, _ in ticks]).numpy()
    guard = torch.stack([tel.guard_fired for tel, _ in ticks]).numpy()
    mine = so.lane_statistics(com, ref_, status, guard)
    red = so.reduce(res.lane_max_err.numpy(), mine["solver_bad"],
                    mine["counts"], len(ticks), scen.com_err_fail)
    return dict(
        lane_max_err=float(np.abs(res.lane_max_err.numpy()
                                  - mine["max_err"]).max()),
        lane_solver_bad=int((res.lane_solver_bad.numpy()
                             != mine["solver_bad"]).sum()),
        status_counts=int(np.abs(res.status_counts.numpy()
                                 - red["status_counts"]).sum()),
        n_failed=abs(int(res.n_failed) - red["n_failed"]),
        n_solver_bad=abs(int(res.n_solver_bad) - red["n_solver_bad"]),
        mean_com_err=abs(float(res.mean_com_err) - red["mean_com_err"]),
        max_com_err=abs(float(res.max_com_err) - red["max_com_err"]),
        solved_frac=abs(float(res.solved_frac) - red["solved_frac"]))


@pytest.fixture(scope="module")
def run(setup):
    """The sweep with the forced retry, and the reference beside it."""
    mp = pytest.MonkeyPatch()
    try:
        forced_retry(setup[0], mp)
        retries = monte_carlo._sweep_tick.retries
        res, ticks = sweep(setup)
        retries = monte_carlo._sweep_tick.retries - retries
    finally:
        mp.undo()
    return res, ticks, references(setup, ticks), retries


def test_sweep_matches_reference_step_by_step(run):
    res, ticks, refs, retries = run
    assert not over(step_gaps(ticks, refs)), over(step_gaps(ticks, refs))
    # the forced lane-tick was re-run, its retry solved and kept: the one
    # retry of the sweep, every lane-tick solved after it
    assert retries == 1
    assert (int(res.n_ticks_retried), int(res.n_ticks_recovered)) == (1, 1)
    status = torch.stack([tel.solver_status for tel, _ in ticks])
    assert bool(((status == 1) | (status == 2)).all())


def test_sweep_statistics_match_reference(run, setup):
    res, ticks, refs, _ = run
    g = statistics_gaps(res, ticks, refs, setup[2])
    assert g["lane_max_err"] < MAX_ERR_TOL, g
    # counts are exact; the mean, worst and solved share are float32 sums
    # of float32 values (one rounding of an O(1) quantity, ~6e-8)
    assert {k: g[k] for k in ("lane_solver_bad", "status_counts",
                              "n_failed", "n_solver_bad")} == dict.fromkeys(
        ("lane_solver_bad", "status_counts", "n_failed", "n_solver_bad"), 0)
    for k in ("mean_com_err", "max_com_err", "solved_frac"):
        assert g[k] < 1e-6, (k, g[k])
    assert int(res.status_counts[:5].sum()) == N_LANES * N_TICKS
    assert float(res.solved_frac) == 1.0 and int(res.n_failed) == 0


def test_lanes_fly_their_own_perturbations(setup):
    """The draw perturbs every lane differently, the model left nominal:
    the reference would refuse it otherwise."""
    p = setup[3].plant
    assert len({tuple(w) for w in p.wind_force.tolist()}) == N_LANES
    assert bool((p.thrust_scale != 1.0).all())
    assert bool((p.mass_scale == 1.0).all())
    assert bool((p.jet_pos_offset == 0.0).all())
    with pytest.raises(ValueError):
        so.check_lane(dict(wind=np.zeros(3), mass_scale=np.full(35, 1.1)))
    with pytest.raises(ValueError):
        so.check_lane(dict(wind=np.zeros(3), jet_pos_offset=np.ones((4, 3))))


def dropped_thrust_scale(setup, monkeypatch):
    """The plant flies every jet at its thrust, the lane's scale
    dropped."""
    real = Plant._substep

    def substep(self, s):
        out = real(self, s._replace(
            thrust_scale=torch.ones_like(s.thrust_scale)))
        return out._replace(thrust_scale=s.thrust_scale)

    monkeypatch.setattr(Plant, "_substep", substep)
    return None


def swapped_lanes(setup, monkeypatch):
    """The program flies lanes 0 and 1 under each other's wind and thrust
    scale."""
    b = setup[3]
    p = b.plant
    order = torch.tensor([1, 0, 2, 3])
    return b._replace(plant=p._replace(
        wind_force=p.wind_force[order], thrust_scale=p.thrust_scale[order]))


def unpicked_retry(setup, monkeypatch):
    """The retry runs but its result is not kept for the bad lanes."""
    forced_retry(setup[0], monkeypatch)
    monkeypatch.setattr(monte_carlo, "_pick", lambda mask, new, old: old)
    return None


FAULTS = {"dropped_thrust_scale": dropped_thrust_scale,
          "swapped_lanes": swapped_lanes, "unpicked_retry": unpicked_retry}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_fails_a_number(setup, fault, monkeypatch):
    batched = FAULTS[fault](setup, monkeypatch)
    res, ticks = sweep(setup, batched)
    monkeypatch.undo()
    refs = references(setup, ticks)
    bad = over(step_gaps(ticks, refs))
    g = statistics_gaps(res, ticks, refs, setup[2])
    assert bad or g["lane_max_err"] >= MAX_ERR_TOL, (bad, g)


def test_benchmark_copy_is_this_reference():
    copy = (ROOT / "mpcbench" / "reference" / "sweep.py").read_text()
    first, rest = copy.split("\n", 1)
    assert first.startswith("# Frozen copy of tests/sweep_oracle.py")
    assert rest == (ROOT / "tests" / "sweep_oracle.py").read_text()


def test_configuration_states_the_flights(setup):
    """``mk3_sweep.json`` flies the flight's loop: its shared sections are
    ``mk3_flight.json``'s, and its scenario is the sweep tool's."""
    sweep_cfg = json.loads(CONFIG.read_text())
    flight_cfg = json.loads(FLIGHT_CONFIG.read_text())
    for k in ("mpc", "robot", "solver", "plant", "ekf", "sim", "model"):
        assert sweep_cfg[k] == flight_cfg[k], k
    assert sweep_cfg["solver"]["ns_skip_tol"] == 0.0
    default = ScenarioConfig()
    sc = sweep_cfg["scenario"]
    assert (sc["thrust_scale_std"], sc["base_vel_std"],
            sc["joint_pos_std"]) == (default.thrust_scale_std,
                                     default.base_vel_std,
                                     default.joint_pos_std)
    assert sc["com_err_fail_m"] == 1.0 and sweep_cfg["recover"] is True
