"""The port's tools (``tools/*_torch.py``) on the CPU at small sizes.

- Every tool's ``main`` runs with ``--device cpu`` and prints the JAX tool's
  stage names or writes its record's keys: the 148 s mission runner
  (``FLIGHT_r05.json``'s keys), the four tick profilers, the refresh-skip
  and joint-limits benches.
- ``make_calibrated_urdf_torch.py`` writes ``data/ironcub_mk3_calibrated.urdf``
  byte for byte.
- ``debug_qp_torch.py``'s dump has ``debug_qp.py``'s keys, each array
  within 1e-4 of its largest entry (the condensed solve's tolerance) of
  the JAX tool's dump of the same hover state.
- ``record_flight_snapshots_torch.py`` writes a stream with the committed
  streams' keys, shapes and dtypes that ``runtime/replay.py`` loads and
  whose first tick replays; with ``--plant-states`` the inputs it also
  writes give its snapshots again through ``compute_snapshot``.
- Every tool that writes refuses a committed record, ``tests/golden/`` and
  ``data/``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tick import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import bench_joint_limits_latency_torch  # noqa: E402
import bench_woodbury_general_torch  # noqa: E402
import bench_ns_skip_torch  # noqa: E402
import bench_segment_streamed_torch  # noqa: E402
import debug_qp_torch  # noqa: E402
import fly_full_trajectory_torch  # noqa: E402
import make_calibrated_urdf_torch  # noqa: E402
import profile_chained_stages_torch  # noqa: E402
import profile_condense_torch  # noqa: E402
import profile_solve_parts_torch  # noqa: E402
import profile_tick_torch  # noqa: E402
import record_flight_snapshots_torch  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = ["--device", "cpu"]
AIRBORNE_KEYS = {"takeoff_t_s", "com_rmse_post_takeoff_m",
                 "com_max_post_takeoff_m", "rpy_rmse_post_takeoff_deg"}


def test_fly_full_trajectory_writes_the_flight_record(tmp_path, capsys):
    out = tmp_path / "FLIGHT_torch.json"
    record = fly_full_trajectory_torch.main(["0.05", "--out", str(out)]
                                            + CPU)
    written = json.loads(out.read_text())
    assert written == record
    reference = json.loads((ROOT / "FLIGHT_r05.json").read_text())
    # flight_stats adds the takeoff keys once the robot is airborne, which
    # it is not 0.05 s in
    assert set(reference) - set(record) == AIRBORNE_KEYS
    assert record["n_ticks"] == record["ticks"] == 10
    assert record["device"] == "cpu" and record["finite"]
    assert record["n_not_solved"] == 0
    # the wrappers count launches of their CUDA kernels only
    assert record["launches"] == {"admm_segment": 0, "woodbury_ns": 0}
    assert f"-> {out}" in capsys.readouterr().out


PROFILERS = {
    "profile_tick": (profile_tick_torch, ["2", "--iters", "1"], (
        "tick_prep(linearize)", "condense", "solve(admm+polish)",
        "solve(no polish)", "solve(no polish, no rho)", "solve(+no scaling)",
        "finish(extract)", "FULL tick")),
    "profile_condense": (profile_condense_torch, ["2", "--iters", "1"], (
        "sequential-full", "structured-full", "paired-full", "chain-seq",
        "chain-struct", "chain-paired", "H-einsum", "H-gemm")),
    "profile_solve_parts": (profile_solve_parts_torch, ["2", "--iters", "1"], (
        "condense (sequential)", "condense (assoc)", "factor(chol+inv)",
        "cholesky only", "scan 60 iters", "one woodbury(2xNS)",
        "2x newton-schulz", "24x24 lin solve",
        "condense nIter=128 (sequential)", "condense nIter=128 (assoc)")),
    "profile_chained_stages": (profile_chained_stages_torch,
                               ["2", "2", "--reps", "1"], (
        "full tick", "prep_only", "prep_condense", "no_polish", "no_guard",
        "no_ns_skip", "term_off", "# stage budget by difference",
        "# per-iteration slope", "max_iter= 40",
        "# max_iter economics", "max_iter= 25:")),
    "bench_ns_skip": (bench_ns_skip_torch, ["2", "2", "--reps", "1"], (
        "refresh_every_tick     jitter=0.00", "skip_tol_0.02          jitter=0.20",
        "jitter=0.0: skip is", "jitter=0.2: skip is")),
    "bench_joint_limits_latency": (bench_joint_limits_latency_torch, ["2"], (
        "joint-limits n_box=120 kernel_mode=off: p50=",
        "joint-limits n_box=120 kernel_mode=on: p50=")),
}


@pytest.mark.parametrize("name", list(PROFILERS))
def test_profilers_and_benches_print_the_jax_stages(name, capsys):
    module, args, stages = PROFILERS[name]
    record = module.main(args + CPU)
    out = capsys.readouterr().out
    for stage in stages:
        assert stage in out, f"{name}: no {stage!r} in\n{out}"
    assert record["tool"] == name and record["device"] == "cpu"
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(record))
    # every time, rate and fraction in the record is finite
    flat = json.dumps(record)
    assert "NaN" not in flat and "Infinity" not in flat


def test_solve_parts_holds_each_kernel_row_to_its_twin():
    record = profile_solve_parts_torch.main(["2", "--iters", "1"] + CPU)
    names = [r["kernel"] for r in record["kernels"]]
    assert names == ["admm_segment", "admm_segment_grouped", "woodbury_ns",
                     "woodbury_ns"]
    for r in record["kernels"]:
        # on the CPU the wrapper runs its twin: the same function exactly
        assert r["rel_err"] == 0.0 and r["launches"] == 0 and r["calls"] == 1
        assert r["P"] == 128 and r["batch"] == 2


def test_bench_woodbury_general_dry_run_prints_the_plans(tmp_path, capsys):
    """On the CPU the general route's bench times the twin and records the
    plan it would launch on the card: 6 launches at n_ns 1, a cluster of 8
    for the long horizon's box of 132, 32-wide tiles at P = 256."""
    out = tmp_path / "bench.json"
    assert bench_woodbury_general_torch.main(["--out", str(out)] + CPU) == 0
    record = json.loads(out.read_text())
    assert record["device"] == "cpu"
    (rec,) = record["records"]
    assert (rec["P"], rec["n_box"], rec["batch"], rec["n_ns"]) == \
        (256, 132, 2, 1)
    assert rec["plan"] == dict(tile=32, cluster=8, gj_in_smem=True,
                               kernels=6, blocks=128)
    assert rec["plain_ms"] > 0 and "choices" not in rec
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        dict(device="cpu", ok=True)


def test_bench_segment_streamed_dry_run_prints_the_plans(tmp_path, capsys):
    """On the CPU the segment routes' bench times the twin and records the
    plan it would launch on the card: the long horizon's P = 256 on a
    cluster of 8, K⁻¹'s strip in registers, one kernel a call."""
    out = tmp_path / "bench.json"
    assert bench_segment_streamed_torch.main(["--out", str(out)] + CPU) == 0
    record = json.loads(out.read_text())
    assert record["device"] == "cpu" and record["ok"]
    (rec,) = record["records"]
    assert (rec["P"], rec["batch"], rec["length"]) == (256, 2, 5)
    assert rec["plan"] == dict(route="cluster", cluster=8,
                               kinv_in_registers=True, spread_cols=0,
                               blocks=16, threads=128, smem_bytes=2048,
                               kernels=1)
    assert rec["plain_ms"] > 0 and "choices" not in rec
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        dict(device="cpu", ok=True)


def test_make_calibrated_urdf_is_byte_identical(tmp_path):
    out = tmp_path / "mk3.urdf"
    make_calibrated_urdf_torch.main(["--out", str(out)])
    assert out.read_bytes() == (ROOT / "data" /
                                "ironcub_mk3_calibrated.urdf").read_bytes()


def test_debug_qp_dump_matches_jax(tmp_path, monkeypatch, capsys):
    import debug_qp

    jax_out = tmp_path / "jax.npz"
    monkeypatch.setattr(sys, "argv", ["debug_qp.py", str(jax_out)])
    debug_qp.main()
    jax_console = capsys.readouterr().out
    port_out = tmp_path / "port.npz"
    debug_qp_torch.main([str(port_out)] + CPU)
    port_console = capsys.readouterr().out
    want, got = np.load(jax_out), np.load(port_out)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, k
    # the same console summary, block by block
    heads = [ln for ln in jax_console.splitlines() if ln.startswith("=")]
    assert heads == [ln for ln in port_console.splitlines()
                     if ln.startswith("=")]
    assert "sum(per-block H) == build_hessian  OK" in port_console


def test_recorded_stream_round_trips_through_replay(tmp_path):
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.qp import mpc
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    out = tmp_path / "stream.npz"
    rec = record_flight_snapshots_torch.main(["1", "2", str(out)] + CPU)
    committed = np.load(ROOT / "tests" / "golden" / "flight_snapshots.npz")
    got = np.load(out)
    assert sorted(got.files) == sorted(committed.files)
    for k in committed.files:
        assert got[k].dtype == committed[k].dtype, k
        assert got[k].shape[1:] == committed[k].shape[1:], k
    assert got["snap_w_R_b"].shape[0] == 3 and got["est_td"].shape[0] == 2
    assert int(got["meta_start_tick"][0]) == 1
    np.testing.assert_array_equal(got["est_td"], rec["est_td"])

    replay = load_flight_replay(out, device="cpu")
    assert replay.n_ticks == 2
    np.testing.assert_array_equal(replay.snaps.w_R_b.numpy(),
                                  got["snap_w_R_b"])
    settings = admm.ADMMSettings(max_iter=400, polish=True)
    problem, carry = replay.configure(settings)
    carry, o = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel, settings,
                            problem, carry, *replay.tick_inputs(0))
    assert int(o.status[0]) in (admm.SOLVED, admm.SOLVED_INACCURATE)
    assert bool(torch.isfinite(o.throttle).all())


def test_recorder_plant_states_recompute_its_snapshots(tmp_path):
    """With --plant-states the recorder also writes the inputs of every
    snapshot; compute_snapshot of them gives the recorded snapshots."""
    from ironcub_mpc_tpu_torch import dynamics as tdyn
    from ironcub_mpc_tpu_torch.core.config import RobotConfig

    out = tmp_path / "states.npz"
    record_flight_snapshots_torch.main(["1", "2", str(out), "--plant-states"]
                                       + CPU)
    got = np.load(out)
    keys = ("base_R", "base_p", "base_vel", "q", "qd", "thrust",
            "sole_wrenches")
    t = [torch.as_tensor(got[f"state_{k}"]) for k in keys]
    assert all(a.shape[0] == 3 for a in t)
    kd = tdyn.KinDyn(tdyn.load_ironcub_model(), device="cpu")
    snap = tdyn.compute_snapshot(
        kd, RobotConfig().jets_list, *t[:6],
        ext_wrench_frames=tuple(str(f) for f in got["meta_sole_frames"]),
        ext_wrenches_body=t[6],
        ground_threshold=float(got["meta_ground_threshold"][0]))
    for f in snap._fields:
        want = got[f"snap_{f}"]
        np.testing.assert_allclose(
            getattr(snap, f).numpy().astype(np.float32), want, rtol=1e-5,
            atol=1e-6 * max(float(np.abs(want).max()), 1.0), err_msg=f)


WRITERS = {
    "fly_full_trajectory": (fly_full_trajectory_torch,
                            lambda p: ["0.05", "--out", p] + CPU),
    "debug_qp": (debug_qp_torch, lambda p: [p] + CPU),
    "make_calibrated_urdf": (make_calibrated_urdf_torch,
                             lambda p: ["--out", p]),
    "record_flight_snapshots": (record_flight_snapshots_torch,
                                lambda p: ["1", "2", p] + CPU),
    "bench_woodbury_general": (bench_woodbury_general_torch,
                               lambda p: ["--out", p] + CPU),
    "bench_segment_streamed": (bench_segment_streamed_torch,
                               lambda p: ["--out", p] + CPU),
}
COMMITTED = ["FLIGHT_r05.json", "SWEEP_r05.json", "MISMATCH_r05.json",
             "tests/golden/flight_snapshots.npz",
             "data/ironcub_mk3_calibrated.urdf"]


@pytest.mark.parametrize("name", list(WRITERS))
def test_tools_refuse_committed_records(name):
    module, argv = WRITERS[name]
    before = {p: (ROOT / p).read_bytes() for p in COMMITTED}
    for p in COMMITTED:
        with pytest.raises(SystemExit, match="refusing"):
            module.main(argv(str(ROOT / p)))
    assert {p: (ROOT / p).read_bytes() for p in COMMITTED} == before


def test_robustness_sweep_runs_three_wind_levels(tmp_path):
    """The sweep tool's main splits its scenarios over SWEEP_r05.json's
    three wind levels, each drawn from seed ``int(w_std * 100)``, and writes
    the record it prints to --out."""
    import run_robustness_sweep_torch as robustness

    out = tmp_path / "sweep.json"
    record = robustness.main(["3", "0.01", "--skip", "0", "--no-resample",
                              "--out", str(out)] + CPU)
    assert json.loads(out.read_text()) == record
    assert [lv["wind_force_std_n"] for lv in record["levels"]] == \
        [5.0, 10.0, 20.0]
    assert record["n_scenarios_total"] == 3 and record["n_ticks"] == 2
    for level in record["levels"]:
        assert level["n_scenarios"] == 1
        assert sum(level["status_counts"].values()) - level[
            "status_counts"]["guard_fired"] == 1 * 2
    assert record["device"] == "cpu"
