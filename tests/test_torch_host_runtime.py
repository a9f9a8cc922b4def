"""The port's host side against the JAX package: the native runtime
library built by the host C++ compiler (ring, pacer, stress), the profiling
helpers, telemetry to ``.mat`` and the MJCF writer.

The native cases are those of tests/test_native_runtime.py, run against
the port's bindings (``ironcub_mpc_tpu_torch.runtime.native``), which build
``native/ironcub_rt.cc`` with g++ into build/torch_native/ at first use.
``to_mat_dict`` and ``mjcf_from_model`` must equal JAX's exactly.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch

from ironcub_mpc_tpu.core.types import DebugInfo as JDebugInfo
from ironcub_mpc_tpu.dynamics import load_ironcub_model as jload_model
from ironcub_mpc_tpu.runtime import telemetry as jtel
from ironcub_mpc_tpu.runtime.loop import TickTelemetry as JTickTelemetry
from ironcub_mpc_tpu.sim import mjcf as jmjcf

from ironcub_mpc_tpu_torch.core.types import DebugInfo, tree_map
from ironcub_mpc_tpu_torch.dynamics import load_ironcub_model
from ironcub_mpc_tpu_torch.runtime import native
from ironcub_mpc_tpu_torch.runtime import telemetry as ttel
from ironcub_mpc_tpu_torch.runtime.loop import TickTelemetry
from ironcub_mpc_tpu_torch.sim import mjcf as tmjcf
from ironcub_mpc_tpu_torch.utils.profiling import (DeadlineMonitor, Timer,
                                                   device_trace,
                                                   solves_per_second)

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def built():
    """The library builds (or is found built) at first use."""
    assert native.available()


# ---------------------------------------------------------------------------
# native runtime: the cases of tests/test_native_runtime.py
# ---------------------------------------------------------------------------


def test_library_is_built_by_gxx_into_build_torch_native():
    path = native.lib_path()
    assert path.parent == ROOT / "build" / "torch_native"
    assert path.name.startswith("libironcub_rt_") and path.exists()
    assert native.build() == path          # built once, found after
    assert not (ROOT / "native" / "build" / path.name).exists()


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cc"):
        native.build()
    assert not list((tmp_path / "out").glob("*.so"))


def test_ring_fifo_and_drop_accounting():
    ring = native.TelemetryRing(capacity=64, record_len=4)
    for i in range(100):
        ring.push(np.full(4, i, np.float32))
    assert ring.size == 64
    assert ring.dropped == 36  # overflow dropped, not overwritten
    out = ring.pop(100)
    assert out.shape == (64, 4)
    np.testing.assert_allclose(out[:, 0], np.arange(64))  # FIFO order
    assert ring.size == 0
    with pytest.raises(ValueError):
        ring.push(np.zeros(3, np.float32))


def test_ring_drain_to_file(tmp_path):
    ring = native.TelemetryRing(capacity=32, record_len=3)
    for i in range(10):
        ring.push(np.array([i, 2 * i, 3 * i], np.float32))
    path = tmp_path / "tel.bin"
    n = ring.drain_to_file(str(path))
    assert n == 10
    back = np.fromfile(path, np.float32).reshape(-1, 3)
    np.testing.assert_allclose(back[:, 1], 2 * np.arange(10))


def test_pacer_keeps_schedule():
    p = native.RealtimePacer(0.002)
    t0 = time.monotonic()
    for _ in range(25):
        p.wait()
    wall = time.monotonic() - t0
    # absolute deadlines: never ahead of the schedule; a loaded box may lag
    assert 0.045 < wall < 0.12, wall
    assert p.ticks == 25


def test_pacer_overrun_accounting():
    p = native.RealtimePacer(0.001)
    time.sleep(0.02)  # blow through ~20 deadlines
    late = p.wait()
    assert late > 0.01
    assert p.overruns >= 1
    assert p.worst_lateness > 0.01


def test_python_fallback_ring_and_pacer(monkeypatch):
    """The fallback, selected by setting _LIB to None on purpose, exposes
    the same semantics."""
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available()
    ring = native.TelemetryRing(capacity=8, record_len=2)
    for i in range(12):
        ring.push(np.array([i, i], np.float32))
    assert ring.size == 8 and ring.dropped == 4
    out = ring.pop(20)
    np.testing.assert_allclose(out[:, 0], np.arange(8))
    p = native.RealtimePacer(0.001)
    time.sleep(0.01)
    assert p.wait() > 0.005 and p.overruns == 1 and p.ticks == 1
    with pytest.raises(RuntimeError):
        native.ring_stress(8, 2, 10)


def test_ring_concurrent_stress_native():
    """Real producer thread vs real consumer thread through the
    acquire/release protocol for 2e6 records: strictly increasing sequence
    numbers, untorn records, consumed + dropped = produced."""
    rc = native.ring_stress(1024, 8, 2_000_000)
    assert rc == 0, f"ring_stress error class {rc}"


def test_ring_concurrent_python_threads():
    """The same race through the Python binding surface (ctypes releases
    the GIL during each call, so the C sides genuinely interleave)."""
    n = 100_000
    ring = native.TelemetryRing(capacity=512, record_len=4)
    stop = threading.Event()
    got = []

    def consume():
        while not stop.is_set() or ring.size:
            out = ring.pop(256)
            if len(out):
                got.append(np.asarray(out))

    t = threading.Thread(target=consume)
    t.start()
    for i in range(n):
        ring.push(np.full(4, i, np.float32))
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    recs = np.concatenate(got) if got else np.zeros((0, 4), np.float32)
    assert np.all(recs == recs[:, :1]), "torn record observed"
    assert np.all(np.diff(recs[:, 0]) > 0), "non-monotonic pop order"
    assert len(recs) + ring.dropped == n


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_timer_and_deadline_monitor():
    t = Timer(window=3)
    for _ in range(5):
        with t:
            pass
    assert len(t.samples) == 5 and t.rolling_mean() >= 0
    assert t.series().shape == (5,) and t.last == t.samples[-1]
    d = DeadlineMonitor(period=0.005, verbose=False)
    assert not d.check(0.004)
    assert d.check(0.006)
    assert d.overruns == 1 and abs(d.worst - 0.001) < 1e-12


def test_solves_per_second_walks_tuples_of_named_tuples():
    calls = []

    def fn(x):
        calls.append(1)
        return (DebugInfo(x, x * 2, None, x, x), [x + 1])

    rate = solves_per_second(8, 4, fn, torch.ones(3))
    assert len(calls) == 5 and rate > 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    text = files[0].read_text()
    assert "traceEvents" in text and "aten::mm" in text
    assert any(ev.key == "aten::mm" for ev in prof.key_averages())


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

T_TICKS = 7
# trailing shape and dtype of each TickTelemetry channel
CHANNELS = dict(
    com_position=(3,), com_position_desired=(3,),
    base_orientation_desired=(3,), base_position=(3,),
    base_orientation=(3,), base_lin_vel=(3,), base_ang_vel=(3,),
    base_lin_vel_filtered=(3,), base_ang_vel_filtered=(3,),
    joints_pos_meas=(23,), joints_vel_meas=(23,), joints_pos_ref=(23,),
    linear_momentum=(3,), angular_momentum=(3,), momentum_reference=(6,),
    estimated_thrust=(4,), estimated_thrust_dot=(4,), thrust_desired=(4,),
    thrust_desired_dot=(4,), alpha_gravity=(), throttle=(4,),
    solver_status=np.int32, pri_res=(), dua_res=(), zmp=(3,),
    on_ground=bool, ext_wrench_sum=(6,), guard_fired=bool)


def _channels(seed, debug):
    """Seeded numpy channels [T, ...] of every field (the debug block of
    512 constraint rows when ``debug``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in CHANNELS.items():
        if spec is np.int32:
            out[name] = rng.integers(1, 6, T_TICKS).astype(np.int32)
        elif spec is bool:
            out[name] = rng.random(T_TICKS) > 0.5
        else:
            out[name] = rng.standard_normal((T_TICKS,) + spec).astype(
                np.float32)
    dbg = None
    if debug:
        dbg = dict(total_cost=rng.standard_normal(T_TICKS),
                   block_costs=rng.standard_normal((T_TICKS, 4)),
                   constraint_lb=rng.standard_normal((T_TICKS, 512)),
                   constraint_ax=rng.standard_normal((T_TICKS, 512)),
                   constraint_ub=rng.standard_normal((T_TICKS, 512)))
        dbg = {k: v.astype(np.float32) for k, v in dbg.items()}
    return out, dbg


@pytest.mark.parametrize("debug", [False, True], ids=["plain", "debug"])
def test_to_mat_dict_equals_jax(debug):
    chans, dbg = _channels(3, debug)
    jtel_in = JTickTelemetry(**chans, debug=None if dbg is None
                             else JDebugInfo(**dbg))
    ttel_in = TickTelemetry(
        **{k: torch.as_tensor(v) for k, v in chans.items()},
        debug=None if dbg is None else DebugInfo(
            **{k: torch.as_tensor(v) for k, v in dbg.items()}))
    want = jtel.to_mat_dict(jtel_in, period=0.005)
    got = ttel.to_mat_dict(ttel_in, period=0.005)
    assert list(got) == list(want)
    assert ("debug_ReferenceTrackingCost_xHx_gx" in got) == debug
    assert "guard_fired" not in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ttel.MAT_KEYS == jtel.MAT_KEYS
    assert ttel.DEBUG_BLOCK_NAMES == jtel.DEBUG_BLOCK_NAMES


def test_save_mat_round_trip(tmp_path):
    chans, _ = _channels(5, False)
    tel = TickTelemetry(**{k: torch.as_tensor(v) for k, v in chans.items()})
    path = ttel.save_mat(tel, str(tmp_path / "run.mat"), period=0.005,
                         extra={"note": np.arange(3)})
    back = scipy.io.loadmat(path)
    want = ttel.to_mat_dict(tel, period=0.005)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.atleast_2d(v), err_msg=k)
    assert back["CoMPosition"].shape == (T_TICKS, 3)
    np.testing.assert_array_equal(back["note"], [[0, 1, 2]])
    # a batched record: lane 0 picked with tree_map
    lanes = tree_map(lambda v: torch.stack([v, v + 1]).transpose(0, 1)
                     if v.is_floating_point() else
                     torch.stack([v, v]).transpose(0, 1), tel)
    one = ttel.to_mat_dict(tree_map(lambda v: v[:, 0], lanes))
    np.testing.assert_array_equal(one["CoMPosition"], want["CoMPosition"])


# ---------------------------------------------------------------------------
# MJCF
# ---------------------------------------------------------------------------


def test_mjcf_of_the_stock_model_equals_jax():
    got = tmjcf.mjcf_from_model(load_ironcub_model())
    want = jmjcf.mjcf_from_model(jload_model())
    assert got == want
    assert got.startswith('<mujoco model="ironcub_tpu">')
