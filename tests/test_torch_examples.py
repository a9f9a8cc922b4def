"""The port's real-time driver, its capture tool and the three demos on the
CPU, against the JAX package where they compute the same thing.

- ``hover_setup`` builds the problem, carry and snapshot of the JAX
  package's ``__graft_entry__._setup`` (compared through ``convert``,
  within 1e-6 of each leaf's largest magnitude).
- ``realtime_driver_torch.run(device="cpu")``: 30 paced ticks at 150 ms,
  about 5x the port's 31 ms CPU tick on one thread, so the loop holds its
  period on any host (at most 3 overruns); no record dropped, every record
  drained and solved, and the first 5 records (ticks 21-25 of the carry,
  after the 20 unpaced warm-up ticks) against 5 chained JAX ticks at the
  batch-1 tolerances (statuses equal, throttle 1e-3 %, thrust_des 1e-3 N).
- ``tools/capture_rt_torch.py`` refuses to write over an existing file.
- hover, closed-loop and flight demos for a few ticks; the flight demo's
  ``.mat`` read back and rendered by tools/visualize_run.render.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch

import jax

import __graft_entry__ as ge
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.qp import mpc as jmpc

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.core.types import tree_map
from ironcub_mpc_tpu_torch.ops import admm

from test_torch_tick import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tools"))

import capture_rt_torch  # noqa: E402
import closed_loop_demo_torch  # noqa: E402
import flight_demo_torch  # noqa: E402
import hover_demo_torch  # noqa: E402
import realtime_driver_torch as rtd  # noqa: E402
import visualize_run  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_PACED, PERIOD_S, N_CHECK = 30, 0.15, 5
WARMUP = 20                       # the driver's unpaced ticks


def _leaves_close(got, want, tol, what):
    """Leaf by leaf of two trees of one structure: each within ``tol`` of
    the reference leaf's largest magnitude (at least 1)."""
    def one(path, g, w):
        g = g.double().numpy()
        w = w.double().numpy()
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * scale, f"{path}: {err:.3e} > {tol} x {scale:.3g}"
        return g

    tree_map(one, got, want, path=what)


def test_hover_setup_matches_the_jax_setup():
    settings = jadmm.ADMMSettings(**rtd.DRIVER_SETTINGS)
    *_, jproblem, jcarry, jsnap, _ = ge._setup(settings=settings)
    _, _, _, _, problem, carry, snap = rtd.hover_setup(
        admm.ADMMSettings(**rtd.DRIVER_SETTINGS), device="cpu")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    _leaves_close(problem, convert.problem_from_numpy(to_np(jproblem), "cpu"),
                  1e-6, "problem")
    _leaves_close(carry, convert.carry_from_numpy(to_np(jcarry), "cpu"),
                  1e-6, "carry")
    _leaves_close(snap, convert.snapshot_from_numpy(to_np(jsnap), "cpu"),
                  1e-6, "snapshot")


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    path = tmp_path_factory.mktemp("rt") / "rt.f32"
    stats = rtd.run(n_ticks=N_PACED, period_s=PERIOD_S, drain_path=str(path),
                    verbose=False, device="cpu")
    rec = np.fromfile(path, np.float32).reshape(N_PACED, -1)
    return stats, rec


def test_realtime_driver_smoke(driven):
    """The native pacer and telemetry ring around the port's tick on the
    CPU (tests/test_aux_subsystems.py::test_realtime_driver_smoke)."""
    stats, rec = driven
    assert stats["ticks"] == N_PACED and stats["native"]
    assert stats["device"] == "cpu"
    assert stats["ring_dropped"] == 0
    assert stats["drained_records"] == N_PACED
    assert stats["overruns"] <= 3, stats
    assert stats["overruns_warmup"] + stats["overruns_steady"] == \
        stats["overruns"]
    assert rec.shape[1] == rtd.RECORD_LEN
    np.testing.assert_array_equal(rec[:, 0], np.arange(N_PACED))
    assert np.all(np.isin(rec[:, 1], (admm.SOLVED, admm.SOLVED_INACCURATE)))
    assert np.all(rec[:, 12] > 0)                       # solve ms


def test_realtime_driver_records_match_chained_jax_ticks(driven):
    _, rec = driven
    settings = jadmm.ADMMSettings(**rtd.DRIVER_SETTINGS)
    cfg, sched, sel, settings, problem, carry, snap, _ = ge._setup(
        settings=settings)
    tick = jax.jit(lambda c: jmpc.mpc_tick(cfg, sched, sel, settings,
                                           problem, c, snap,
                                           jax.numpy.zeros(4)))
    outs = []
    for _ in range(WARMUP + N_CHECK):
        carry, out = tick(carry)
        outs.append(out)
    for k in range(N_CHECK):
        out, r = outs[WARMUP + k], rec[k]
        assert int(r[1]) == int(out.status), k
        np.testing.assert_allclose(r[4:8], np.asarray(out.throttle), rtol=0,
                                   atol=1e-3, err_msg=f"record {k} throttle")
        np.testing.assert_allclose(r[8:12], np.asarray(out.thrust_des),
                                   rtol=0, atol=1e-3,
                                   err_msg=f"record {k} thrust_des")


def test_capture_rt_torch_refuses_an_existing_file(tmp_path):
    path = tmp_path / "RT_torch_old.json"
    path.write_text("{}\n")
    with pytest.raises(SystemExit, match="exists"):
        capture_rt_torch.main(["5", str(path), "--device", "cpu"])
    assert path.read_text() == "{}\n"
    # the committed CPU record of the JAX package, by its relative name
    with pytest.raises(SystemExit, match="exists"):
        capture_rt_torch.main(["5", "RT_r05.json", "--device", "cpu"])


def test_hover_demo_runs_on_the_cpu():
    statuses = hover_demo_torch.main(["5", "--device", "cpu"])
    assert statuses == [admm.SOLVED] * 5


def test_closed_loop_demo_runs_on_the_cpu():
    tel = closed_loop_demo_torch.main(["3", "--device", "cpu"])
    assert tuple(tel.com_position.shape) == (3, 1, 3)
    assert torch.isin(tel.solver_status,
                      torch.tensor([admm.SOLVED,
                                    admm.SOLVED_INACCURATE])).all()


def test_flight_demo_saves_a_mat_that_renders(tmp_path):
    mat_path = tmp_path / "flight.mat"
    tel, info, path = flight_demo_torch.main(
        ["0.05", "--device", "cpu", "--save-mat", str(mat_path)])
    assert path == str(mat_path) and info["n_ticks"] == 10
    mat = scipy.io.loadmat(path, squeeze_me=False)
    assert mat["CoMPosition"].shape == (10, 3)
    assert mat["joints_pos_ref"].shape == (10, 23)
    np.testing.assert_array_equal(mat["CoMPosition"],
                                  tel.com_position.numpy())
    png = visualize_run.render(mat, str(tmp_path / "flight.png"))
    assert Path(png).stat().st_size > 10_000
