"""The Monte-Carlo sweep of the port against the JAX package's, on the CPU.

Built on the ``loop_setup`` of tests/test_parallel.py: the calibrated Mk3
model, direct thrust (``use_nn_jet_dynamics=False``),
``ADMMSettings(max_iter=60)``, 0.2 s settle in JAX, zero trajectory
channels. Batch-wide decisions on both sides: the JAX loop flies with
``guard_axis=BATCH_GUARD_AXIS`` (set after configure, as the sweep tools
do) and the port with ``batch_guard=True``. JAX runs its sweep on a mesh of
one device, so its batch-wide decisions range over all 8 lanes as the
port's do (on the 8-device mesh of tests/test_parallel.py each device would
decide for its own lane). JAX's batched carry
(``make_batched_carry(carry, 8, scen, seed)``) is carried across as numpy.

Compared over 4 ticks: the status histogram (in the recovery case with its
two solved columns summed, for the reason given there), failure and
solver-bad counts, solved_frac and, with recovery, the retried and recovered
tick counts are equal; the CoM errors (per lane, mean, worst) agree within 1e-4 m, the CoM
tolerance of tests/test_torch_loop.py (both sides sum in other orders and
the JAX CPU path solves in the unpadded layout, the port in the padded
layout of its kernels). Three JAX sweeps in all: each compiles anew.

The port-only cases need no JAX: resume after a checkpoint equals an
uninterrupted sweep, the checkpoint round trip of runtime/checkpoint.py, the
draws of make_batched_carry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ironcub_mpc_tpu.core.config import MPCConfig as JMPCConfig
from ironcub_mpc_tpu.core.config import RobotConfig as JRobotConfig
from ironcub_mpc_tpu.core.config import SimConfig as JSimConfig
from ironcub_mpc_tpu.dynamics import KinDyn as JKinDyn
from ironcub_mpc_tpu.dynamics import load_ironcub_model as jload_model
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.parallel import monte_carlo as jmc
from ironcub_mpc_tpu.parallel import make_mesh as jmake_mesh
from ironcub_mpc_tpu.runtime import flight as jflight
from ironcub_mpc_tpu.runtime.loop import ClosedLoop as JClosedLoop
from ironcub_mpc_tpu.sim.plant import Plant as JPlant

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.core.config import MPCConfig, RobotConfig, SimConfig
from ironcub_mpc_tpu_torch.core.types import expand_lanes, tree_map
from ironcub_mpc_tpu_torch.dynamics import KinDyn, load_ironcub_model
from ironcub_mpc_tpu_torch.ops import admm
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.parallel import (
    STATUS_COLS, ScenarioConfig, SweepResult, make_batched_carry, make_mesh,
    multihost_init, recovery_settings, run_sweep, scenario_shard)
from ironcub_mpc_tpu_torch.qp import condensed
from ironcub_mpc_tpu_torch.runtime import checkpoint
from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
from ironcub_mpc_tpu_torch.sim.plant import Plant

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES, N_TICKS = 8, 4
COM_TOL = 1e-4
CHANNELS = {k: np.zeros((30, 3)) for k in
            ("positionCoM", "velocityCoM", "RPY", "RPYDot")}
ALPHA = np.full(600, 0.08)
SWEEP = ScenarioConfig(wind_force_std=2.0, thrust_scale_std=0.02,
                       base_vel_std=0.01, joint_pos_std=0.002)
# name: (scenario, seed, crippled primary solver, recover)
CASES = {
    "plain": (SWEEP, 2, False, False),
    "mismatch": (ScenarioConfig(wind_force_std=0.0, thrust_scale_std=0.0,
                                base_vel_std=0.0, joint_pos_std=0.0,
                                mass_scale_std=0.10, jet_pos_std_m=0.01), 3,
                 False, False),
    "recovery": (SWEEP, 9, True, True),
}
CRIPPLE = dict(max_iter=3, rho_update_iters=(), polish=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_loop(settings=None, sim=None):
    kd = KinDyn(load_ironcub_model(), device="cpu")
    plant = Plant(kd, RobotConfig(),
                  sim or SimConfig(use_nn_jet_dynamics=False))
    return ClosedLoop(plant, MPCConfig(), settings or admm.ADMMSettings(
        max_iter=60, batch_guard=True))


@pytest.fixture(scope="module")
def setup():
    plant = JPlant(JKinDyn(jload_model()), JRobotConfig(),
                   JSimConfig(use_nn_jet_dynamics=False))
    jl = JClosedLoop(plant, JMPCConfig(), jadmm.ADMMSettings(max_iter=60))
    s = jflight.standing_state(plant, JSimConfig().initial_position_deg)
    s = jax.jit(lambda s: jl.settle(s, 0.2))(s)
    jproblem, jcarry = jl.configure(s, CHANNELS, ALPHA)
    # batch-wide decisions once the lanes are batched (the sweep tools'
    # order: the unbatched configure has no guard axis to reduce over)
    jl.settings = dataclasses.replace(jl.settings,
                                      guard_axis=jadmm.BATCH_GUARD_AXIS)
    tl = _port_loop()
    tproblem = convert.problem_from_numpy(_np(jproblem), "cpu")
    tcarry = convert.loop_carry_from_numpy(
        _np(jcarry._replace(plant=jcarry.plant._replace(rng=None))), "cpu")
    return dict(jl=jl, jproblem=jproblem, jcarry=jcarry, tl=tl,
                tproblem=tproblem, tcarry=tcarry,
                mesh=jmake_mesh(n_scenario=1, n_kkt=1,
                                devices=jax.devices()[:1]))


def _jax_traced(jl, monkeypatch, tmp_path):
    """Trace JAX's sweep lane-tick by lane-tick without touching the
    package: every tick of the loop (first attempt and recovery retry)
    hands its status and residuals to the host through
    ``jax.debug.callback``, and the sweep, run one tick a chunk, marks the
    end of each tick where it would write its checkpoint, with the per-lane
    status histogram so far. Returns the ``run_sweep`` keyword arguments
    and the function that turns the trace into ``[ticks, lanes]`` arrays of
    status, primal and dual residual, and the mask of the lane-ticks the
    recovery retry re-ran."""
    events, marks = [], []
    tick = jl.tick

    def traced(problem, carry, settings=None):
        carry, tel = tick(problem, carry, settings)
        jax.debug.callback(
            lambda *a: events.append(tuple(np.asarray(v) for v in a)),
            settings is not None, jax.lax.axis_index(jadmm.BATCH_GUARD_AXIS),
            tel.solver_status, tel.pri_res, tel.dua_res)
        return carry, tel

    monkeypatch.setattr(jl, "tick", traced, raising=False)
    monkeypatch.setattr(jmc, "_sweep_ckpt_save", lambda path, carry, acc,
                        done: marks.append((len(events), np.asarray(acc[3]))))

    def arrays():
        status = np.zeros((len(marks), N_LANES), np.int64)
        res = np.zeros((2, len(marks), N_LANES))
        retried = np.zeros((len(marks), N_LANES), bool)
        start, cnt0 = 0, np.zeros((N_LANES, len(jmc.STATUS_COLS)), np.int64)
        for t, (stop, cnt) in enumerate(marks):
            # the status the sweep counted for each lane at this tick
            status[t] = 1 + np.argmax(cnt[:, :5] - cnt0[:, :5], axis=1)
            first, retry = {}, {}
            for is_retry, lane, st, pri, dua in events[start:stop]:
                (retry if is_retry else first)[int(lane)] = (int(st), pri, dua)
            for lane in range(N_LANES):
                st, pri, dua = first[lane]
                if st >= jadmm.PRIMAL_INFEASIBLE and lane in retry:
                    st, pri, dua = retry[lane]
                    retried[t, lane] = True
                assert st == status[t, lane], (t, lane)
                res[:, t, lane] = pri, dua
            start, cnt0 = stop, cnt
        return (status, res[0], res[1]), retried

    return dict(chunk_ticks=1, checkpoint_dir=str(tmp_path / "jax_ck")), \
        arrays


def _both(setup, name, monkeypatch=None, tmp_path=None):
    """The JAX and the port sweep of one case on the same lanes; with
    ``monkeypatch`` both sweeps are also traced lane-tick by lane-tick
    (``[ticks, lanes]`` arrays of status, primal and dual residual, and
    JAX's mask of retried lane-ticks)."""
    scen, seed, crippled, recover = CASES[name]
    jl, tl = setup["jl"], setup["tl"]
    jb = jmc.make_batched_carry(setup["jcarry"], N_LANES, scen, seed=seed)
    tb = convert.loop_carry_from_numpy(
        _np(jb._replace(plant=jb.plant._replace(rng=None))), "cpu",
        batched=True)
    j_kw, j_arrays, t_trace = {}, None, []
    if monkeypatch is not None:
        j_kw, j_arrays = _jax_traced(jl, monkeypatch, tmp_path)
    j_old, t_old = jl.settings, tl.settings
    try:
        if crippled:
            jl.settings = dataclasses.replace(j_old, **CRIPPLE)
            tl.settings = dataclasses.replace(t_old, **CRIPPLE)
        jres = jmc.run_sweep(jl, setup["jproblem"], jb, n_ticks=N_TICKS,
                             mesh=setup["mesh"], scen=scen, recover=recover,
                             **j_kw)
        jres = _np(jres)
        kernels.reset_launches()
        condensed.batch_any.syncs = 0
        tres = run_sweep(tl, setup["tproblem"], tb, N_TICKS, scen=scen,
                         recover=recover, on_tick=lambda tel: t_trace.append(
                             (tel.solver_status, tel.pri_res, tel.dua_res)))
        syncs = condensed.batch_any.syncs
    finally:
        jl.settings, tl.settings = j_old, t_old
    traces = None
    if j_arrays is not None:
        j_trace, retried = j_arrays()
        traces = (j_trace, tuple(torch.stack(v).numpy()
                                 for v in zip(*t_trace)), retried)
    return jres, tres, syncs, traces


# A lane-tick may close SOLVED on one side and SOLVED_INACCURATE on the
# other only where each of its two residuals, primal and dual, agrees
# between the sides within this factor: the width of the solver's own
# SOLVED_INACCURATE band (residuals up to 10× the threshold). The sides'
# thresholds (eps_abs + eps_rel · the iterate's own scale) agree as their
# iterates do, and the statuses say the threshold lies between the two
# residuals, so each residual then lies within this factor of it. Why the
# residuals part at all: the adaptive ρ's ratio at a ρ mark divides a
# primal residual at float32 rounding (~1e-6), so two sides that sum in
# other orders leave the recovery retry's three marks with other ρ and K⁻¹,
# and the crippled 3-iteration solves of the next ticks, which start from
# them, end with residuals apart (the recovery case: 8 of 32 lane-ticks
# flip, all on the ticks after the retried first, primal residuals up to
# 2.7× apart; JAX's own Pallas and pure paths part the same way,
# tests/test_torch_tick.py::test_solve_at_recovery_settings_matches_jax).
FLIP_FACTOR = 10.0


def _check_lane_ticks(a, b, factor=FLIP_FACTOR):
    """Statuses equal lane-tick by lane-tick but SOLVED / SOLVED_INACCURATE
    flips whose residuals agree within ``factor``; returns the flips."""
    (sa, pa, da), (sb, pb, db) = a, b
    assert sa.shape == sb.shape
    flips = np.argwhere(sa != sb)
    for t, lane in flips:
        assert {int(sa[t, lane]), int(sb[t, lane])} == {
            admm.SOLVED, admm.SOLVED_INACCURATE}, (t, lane)
        for x, y in ((pa, pb), (da, db)):
            x, y = float(x[t, lane]), float(y[t, lane])
            assert max(x, y) <= factor * min(x, y), (t, lane, x, y)
    return flips


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_matches_jax(setup, name, monkeypatch, tmp_path):
    if name == "recovery":
        jres, tres, syncs, traces = _both(setup, name, monkeypatch, tmp_path)
    else:
        jres, tres, syncs, traces = _both(setup, name)
    assert isinstance(tres, SweepResult)
    assert tres._fields == jmc.SweepResult._fields
    assert STATUS_COLS == jmc.STATUS_COLS
    assert int(tres.n_scenarios) == int(jres.n_scenarios) == N_LANES
    got, want = tres.status_counts.numpy(), jres.status_counts
    if traces is not None:
        # after the retry's three adaptive-ρ marks a lane-tick may end
        # SOLVED on one side and SOLVED_INACCURATE on the other
        # (FLIP_FACTOR): held lane-tick by lane-tick, each trace against its
        # own histogram, then the histograms with their two solved columns
        # as one
        j_trace, t_trace, retried = traces
        flips = _check_lane_ticks(j_trace, t_trace)
        for (st, _, _), hist in zip((j_trace, t_trace), (want, got)):
            np.testing.assert_array_equal(
                [(st == c).sum() for c in range(1, 6)], hist[:5])
        assert retried.sum() == int(jres.n_ticks_retried)
        print(f"recovery: {len(flips)} of {retried.size} lane-ticks flip "
              f"SOLVED / SOLVED_INACCURATE, {int(retried.sum())} retried")
        got = np.concatenate([[got[0] + got[1]], got[2:]])
        want = np.concatenate([[want[0] + want[1]], want[2:]])
    np.testing.assert_array_equal(got, want)
    assert int(tres.status_counts[:5].sum()) == N_LANES * N_TICKS
    for f in ("n_failed", "n_solver_bad", "n_ticks_retried",
              "n_ticks_recovered"):
        assert int(getattr(tres, f)) == int(getattr(jres, f)), f
    assert float(tres.solved_frac) == float(jres.solved_frac)
    np.testing.assert_array_equal(tres.lane_solver_bad.numpy(),
                                  jres.lane_solver_bad)
    for f in ("lane_max_err", "mean_com_err", "max_com_err"):
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   getattr(jres, f), rtol=0, atol=COM_TOL,
                                   err_msg=f)
    # the CPU run took the twins and launched no kernel
    assert kernels.admm_segment.launches == 0
    assert kernels.woodbury_ns.launches == 0
    if name == "recovery":
        # the cripple leaves ticks bad, the retry repairs some, and the
        # predicate is read on the host once a tick besides the solver's
        # own gates
        assert int(tres.n_ticks_retried) > 0
        assert 0 < int(tres.n_ticks_recovered) <= int(tres.n_ticks_retried)
        assert syncs >= N_TICKS
    else:
        assert int(tres.n_failed) == 0 and float(tres.solved_frac) > 0.99
        assert int(tres.n_ticks_retried) == 0


# ---------------------------------------------------------------------------
# port-only cases
# ---------------------------------------------------------------------------


def _equal(a, b):
    for f in ("n_scenarios", "n_failed", "n_solver_bad", "status_counts",
              "n_ticks_recovered", "n_ticks_retried", "lane_solver_bad",
              "solved_frac"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("lane_max_err", "mean_com_err", "max_com_err"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), rtol=0, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("noise", [False, True], ids=["quiet", "noisy"])
def test_resume_after_checkpoint_equals_uninterrupted(setup, tmp_path,
                                                      noise):
    """4 ticks, then a fresh call on the same directory for 8, against 8
    uninterrupted ticks in chunks of 4; with sensor noise the generator's
    state is restored with the carry."""
    tl = setup["tl"]
    if noise:
        tl = _port_loop(tl.settings, SimConfig(use_nn_jet_dynamics=False,
                                               simulate_noise=True))
    scen = ScenarioConfig(wind_force_std=2.0, com_err_fail=1.0)
    batched = make_batched_carry(setup["tcarry"], 4, scen, seed=5)

    def sweep(n_ticks, ck=None):
        tl.plant.seed_noise(11)
        return run_sweep(tl, setup["tproblem"], batched, n_ticks, scen=scen,
                         chunk_ticks=4, checkpoint_dir=ck)

    ref = sweep(8)
    ck = tmp_path / "sweep_ck"
    sweep(4, str(ck))
    assert (ck / "sweep_state.pt").exists()
    assert sorted(p.name for p in ck.iterdir()) == ["sweep_state.pt"]
    res = sweep(8, str(ck))          # a fresh call resumes at tick 4
    _equal(res, ref)
    if noise:
        other = sweep(8)             # the noise reaches the result
        tl.plant.seed_noise(12)
        moved = run_sweep(tl, setup["tproblem"], batched, 8, scen=scen)
        _equal(other, ref)
        assert not torch.equal(moved.lane_max_err, ref.lane_max_err)


def test_checkpoint_round_trip_then_tick(setup, tmp_path):
    """save → restore on templates gives the same tensors, and a tick after
    the restore equals a tick without; shapes and dtypes are checked, and a
    write leaves no temporary file."""
    tl, problem = setup["tl"], setup["tproblem"]
    carry = make_batched_carry(setup["tcarry"], 2, SWEEP, seed=1)
    path = tmp_path / "ck" / "run.pt"
    tl.plant.seed_noise(3)
    assert checkpoint.save(path, problem, carry, 17, plant=tl.plant) == \
        str(path.absolute())
    assert sorted(p.name for p in path.parent.iterdir()) == ["run.pt"]
    state = tl.plant.noise_state()
    tl.plant.seed_noise(99)
    p2, c2, step = checkpoint.restore(path, problem, carry, plant=tl.plant)
    assert step == 17
    assert torch.equal(tl.plant.noise_state(), state)
    flat_a = checkpoint.flatten("c", carry)
    flat_b = checkpoint.flatten("c", c2)
    assert flat_a.keys() == flat_b.keys() and "c.plant.base_p" in flat_a
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k
    for a, b in zip(checkpoint.flatten("p", problem).values(),
                    checkpoint.flatten("p", p2).values()):
        assert torch.equal(a, b)
    c_a, tel_a = tl.tick(problem, carry)
    c_b, tel_b = tl.tick(p2, c2)
    assert torch.equal(tel_a.com_position, tel_b.com_position)
    assert torch.equal(c_a.mpc.kinv, c_b.mpc.kinv)
    # a template of another batch size or dtype is refused
    with pytest.raises(ValueError, match="carry.plant.base_R"):
        checkpoint.restore(path, problem,
                           make_batched_carry(setup["tcarry"], 3, SWEEP))
    bad = carry._replace(plant=carry.plant._replace(
        q=carry.plant.q.double()))
    with pytest.raises(ValueError, match="carry.plant.q"):
        checkpoint.restore(path, problem, bad)
    # a template with None where a tensor was saved is refused too
    with pytest.raises(ValueError, match="carry.plant.q: saved, but"):
        checkpoint.restore(path, problem, carry._replace(
            plant=carry.plant._replace(q=None)))


def test_tree_map_walks_paths_and_pairs_trees(setup):
    """The one walker of the package's named-tuple trees: leaf by leaf
    over one or several trees of one structure, with dotted paths on
    request, None leaves kept."""
    carry = setup["tcarry"]
    paths = []
    same = tree_map(lambda p, t: paths.append(p) or t, carry, path="c")
    assert paths[0] == "c.plant.base_R" and "c.mpc.kinv" in paths
    assert list(checkpoint.flatten("c", carry)) == paths
    assert same.plant.rng is None and same.mpc.kinv is carry.mpc.kinv
    two = make_batched_carry(carry, 2, SWEEP, seed=1)
    summed = tree_map(lambda a, b: a + b, two, two)
    assert torch.equal(summed.plant.q, 2 * two.plant.q)
    assert torch.equal(expand_lanes(carry.plant, 3).q,
                       carry.plant.q.expand(3, -1))


def test_make_batched_carry_draws(setup):
    """Seeded draws: the same seed gives the same lanes, another seed other
    lanes; the mass scale is clipped to [0.2, 5]; zero standard deviations
    leave every lane the configured carry."""
    carry = setup["tcarry"]
    wide = ScenarioConfig(mass_scale_std=10.0, jet_pos_std_m=0.02)
    a = make_batched_carry(carry, 64, wide, seed=4)
    b = make_batched_carry(carry, 64, wide, seed=4)
    c = make_batched_carry(carry, 64, wide, seed=5)
    for x, y in zip(checkpoint.flatten("c", a).values(),
                    checkpoint.flatten("c", b).values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.plant.wind_force, c.plant.wind_force)
    ms = a.plant.mass_scale
    assert ms.shape == (64, carry.plant.mass_scale.shape[-1])
    assert float(ms.min()) == float(torch.tensor(0.2, dtype=ms.dtype))
    assert float(ms.max()) == 5.0
    assert a.plant.jet_pos_offset.shape == (64, 4, 3)
    assert 5.0 < float(a.plant.wind_force.std()) < 15.0
    # every lane starts from the configured carry but the perturbed fields
    assert torch.equal(a.mpc.kinv, carry.mpc.kinv.expand(64, -1, -1))
    zero = ScenarioConfig(wind_force_std=0.0, thrust_scale_std=0.0,
                          base_vel_std=0.0, joint_pos_std=0.0)
    z = make_batched_carry(carry, 3, zero, seed=4)
    for k, v in checkpoint.flatten("c", z).items():
        ref = checkpoint.flatten("c", carry).get(k)
        if ref is None:              # the perturbation fields of a JAX carry
            continue
        assert torch.equal(v, ref.expand_as(v)), k
    assert torch.equal(z.plant.wind_force, torch.zeros(3, 3))
    assert torch.equal(z.plant.mass_scale, torch.ones_like(z.plant.mass_scale))
    with pytest.raises(ValueError, match="one-lane"):
        make_batched_carry(a, 2, zero)


def test_recovery_settings_and_mesh(monkeypatch):
    s = admm.ADMMSettings(max_iter=60, term_check_every=5, batch_guard=True)
    r = recovery_settings(s)
    assert (r.kinv_reset, r.max_iter, r.rho_update_iters,
            r.term_check_every) == (True, 200, (25, 75, 150), 0)
    assert recovery_settings(dataclasses.replace(s, max_iter=150)).max_iter \
        == 300
    assert r.batch_guard and r.kernel_mode == "auto"
    j = jmc.recovery_settings(jadmm.ADMMSettings(max_iter=60))
    assert (j.kinv_reset, j.max_iter, j.rho_update_iters,
            j.term_check_every) == (r.kinv_reset, r.max_iter,
                                    r.rho_update_iters, r.term_check_every)
    assert [f.name for f in dataclasses.fields(ScenarioConfig)] == \
        [f.name for f in dataclasses.fields(jmc.ScenarioConfig)]
    assert ScenarioConfig() == ScenarioConfig(
        **dataclasses.asdict(jmc.ScenarioConfig()))
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.scenario_group,
            mesh.kkt_group) == (1, 0, None, None)
    assert scenario_shard(mesh, 8) == slice(0, 8)
    assert scenario_shard(None, 3) == slice(0, 3)
    with pytest.raises(ValueError, match="world"):
        make_mesh(n_kkt=2, device="cpu")
    with pytest.raises(ValueError, match="world"):
        make_mesh(n_scenario=2, device="cpu")
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost_init() is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()


def test_sweep_tools_arguments_and_output_guard(tmp_path):
    """The port's sweep tools take the JAX tools' command line and write
    only where --out points, never over a committed sweep record."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "tools"))
    import run_mismatch_sweep_torch as mismatch
    import run_robustness_sweep_torch as robustness

    n, seconds, opts = robustness.parse_args(
        ["512", "5", "--skip", "3", "--out", "x.json", "--ckpt", "ck",
         "--no-recover", "--no-resample", "--ns-skip"])
    assert (n, seconds) == (512, 5.0)
    assert opts == {"skip": "3", "out": "x.json", "ckpt": "ck",
                    "no-recover": True, "no-resample": True, "ns-skip": True}
    assert robustness.parse_args([])[:2] == (256, 10.0)
    assert robustness.parse_args(["--wind", "10", "64", "--quick"]) == \
        (64, 10.0, {"wind": "10", "quick": True})
    for name in ("SWEEP_r05.json", "MISMATCH_r05.json",
                 "MISMATCH_W20_r05.json"):
        with pytest.raises(SystemExit, match="refusing"):
            robustness.out_path({"out": str(root / name)})
        assert robustness.out_path({"out": str(tmp_path / name)}) == \
            tmp_path / name
    assert robustness.out_path({}) is None
    assert robustness.WIND_LEVELS == (5.0, 10.0, 20.0)
    assert robustness.CHUNK_TICKS == 250
    assert mismatch.LEVELS == ((0.0, 0.0), (0.05, 0.005), (0.10, 0.01),
                               (0.20, 0.02))
    assert robustness.device_entry(torch.device("cpu")) == "cpu"
