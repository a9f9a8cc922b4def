"""The sweep cell (``mk3_sweep.sweep_b1024``, ``mpcbench/loops/sweep.py``)
on the CPU and, ``-m gpu``, on the card: its mix and configuration, its
reference, the program's sweep counters as the harness reads them, the new
readers on a trace with nothing to read, the loop's refusal of a program
without the sweep's counters, a short window through the driver, and its
own fault, the retry's result not kept."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpcbench.core import driver, port, spec, trace, traffic

from test_mpcbench_flight import mix
from test_mpcbench_imports import BLOCK, FORBIDDEN, ROOT, imported_names, \
    python
from test_mpcbench_spans import event

CELL = "mk3_sweep.sweep_b1024"
SHORT = dict(lanes=4, check_lanes=2, ticks=4, warm_passes=0, trace_ticks=2,
             check_ticks=2, chain_ticks=3)
READERS = [m["name"] for m in spec.benchmark()["per_layer"]
           if m["name"].endswith(".sweep")]
SHARED = ("mpc", "robot", "solver", "plant", "ekf", "sim", "model")


def test_mix_keys_and_validate(tmp_path):
    """The mix as the driver reads it: the sweep loop, the flight's keys,
    the cell's values; ``validate`` refuses what the loop cannot run."""
    t = mix(CELL)
    loop = spec.loop(t["loop"])
    assert t["loop"] == "sweep" and set(loop.KEYS) <= set(t)
    assert (t["lanes"], t["decisions"], t["commands_to_host"], t["ticks"],
            t["wind_sigma_N"], t["warm_passes"], t["trace_ticks"]) == (
        1024, "batch_wide", "every_pass", 200, 5.0, 1, 40)
    assert (t["start"], t["starts"]) == ("flight_start", ["flight_airborne"])
    assert (t["check_lanes"], t["check_ticks"], t["chain_ticks"]) == (8, 40,
                                                                     40)
    raw = json.loads(spec.traffic_path("sweep_b1024").read_text())
    for bad in (dict(decisions="each"), dict(check_ticks="some")):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({**raw, **bad}))
        with pytest.raises(ValueError):
            traffic.load(path)
    del raw["ticks"]
    path = tmp_path / "short.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(ValueError):
        traffic.load(path)


def test_configuration_shares_the_flights_sections():
    bench = spec.benchmark()
    sweep_cfg = spec.config(bench, "mk3_sweep")
    flight_cfg = spec.config(bench, "mk3_flight")
    for k in SHARED:
        assert sweep_cfg[k] == flight_cfg[k], k
    assert sweep_cfg["solver"]["ns_skip_tol"] == 0.0
    assert sweep_cfg["scenario"] == dict(
        thrust_scale_std=0.05, base_vel_std=0.05, joint_pos_std=0.01,
        mass_scale_std=0.0, jet_pos_std_m=0.0, com_err_fail_m=1.0)
    assert sweep_cfg["recover"] is True and sweep_cfg["lanes"] == 1024
    entry = next(c for c in bench["configs"] if c["name"] == "mk3_sweep")
    assert entry["reduced"] == ["seconds"] and sweep_cfg["reduced"] == [
        "seconds"]
    # no width is cut
    assert sweep_cfg["sizes"] == dict(flight_cfg["sizes"], lanes=1024)


def test_reference_copy_is_the_tests_reference():
    copy = (ROOT / "mpcbench" / "reference" / "sweep.py").read_text()
    first, rest = copy.split("\n", 1)
    assert first.startswith("# Frozen copy of tests/sweep_oracle.py")
    assert rest == (ROOT / "tests" / "sweep_oracle.py").read_text()


SWEEP_REF = """
from mpcbench.reference import sweep
import numpy as np
z = np.load({carry!r})
state = {{k: z["carry.plant." + k.replace("ekf_", "ekf.")][0]
         for k in sweep.PLANT_FIELDS}}
lane = dict(wind=np.array([1.0, -2.0, 0.5]), thrust_scale=np.full(4, 1.05))
out = sweep.chain_pass({config!r}, {start!r}, {carry!r}, lane, state, 1)
assert out[0]["observed"]["com_ref"].shape == (3,)
print(sorted({{m.split(".")[0] for m in sys.modules}} & BLOCKED))
"""


def test_sweep_reference_loads_nothing_of_the_program():
    """The sweep's float64 reference flies a perturbed tick with the
    program and JAX refused at import; its original in ``tests/`` names
    neither."""
    blocked = sorted(FORBIDDEN | {"ironcub_mpc_tpu_torch"})
    code = (BLOCK.format(root=str(ROOT), blocked=blocked)
            + SWEEP_REF.format(
                config=str(ROOT / "mpcbench" / "configs" / "mk3_sweep.json"),
                start=str(spec.stream_path("flight_start")),
                carry=str(spec.stream_path("flight_airborne"))))
    assert python(code) == "[]"
    names = imported_names(ROOT / "tests" / "sweep_oracle.py")
    assert not names & (FORBIDDEN | {"ironcub_mpc_tpu_torch", "mpcbench"})


def test_new_counters_are_reached():
    """``port.counters()`` reaches the sweep's counters on module-level
    functions, under the names the readers read."""
    from ironcub_mpc_tpu_torch.parallel import monte_carlo  # noqa: F401

    c = port.counters()
    for key in ("parallel.monte_carlo._sweep_tick.ticks",
                "parallel.monte_carlo._sweep_tick.retries",
                "parallel.monte_carlo.run_sweep.sweeps"):
        assert type(c[key]) is int, key


@pytest.mark.parametrize("name", READERS)
def test_new_reader_reads_none_with_nothing_to_read(name):
    """Each new reader on a trace that holds none of what it reads (no
    sweep span, no sweep counter, no kernel call: the parent's program)
    returns None and raises nothing; without a trace, the same."""
    events = [event(trace.WINDOW_SPAN, 0.0, 10.0), event("other", 1, 2)]
    empty = trace.Trace(start_us=0.0, end_us=10.0, window_s=1e-5,
                        busy_s=0.0, kernels=[], device_ops=[], idle_gaps=[])
    read = spec.metric_reader(name)
    for tr in (empty, None):
        ctx = dict(events=events, ticks=1, trace=tr, counters={}, calls={},
                   roofline=spec.roofline, peaks=spec.peaks(),
                   memory_peak_bytes=None, lanes=4)
        assert read(ctx) is None, name


def test_counter_readers_divide_by_what_they_count():
    c = "parallel.monte_carlo._sweep_tick."
    read = spec.metric_reader("sweep_retries_per_tick.sweep")
    assert read(dict(ticks=40, counters={c + "ticks": 40,
                                         c + "retries": 2})) == 0.05
    assert read(dict(ticks=40, counters={c + "ticks": 0,
                                         c + "retries": 0})) is None
    read = spec.metric_reader("host_readbacks_per_tick.sweep")
    assert read(dict(ticks=40, counters={
        "qp.condensed.batch_any.syncs": 1120})) == 28.0


def test_sweep_host_ms_sums_its_spans():
    ctx = dict(ticks=2, trace=SimpleNamespace(),
               events=[event(trace.WINDOW_SPAN, 0.0, 10000.0),
                       event("sweep.gate", 100.0, 300.0),
                       event("sweep.stats", 400.0, 500.0),
                       event("sweep.gate", 1100.0, 1300.0),
                       event("sweep.retry", 1300.0, 2300.0),
                       event("sweep.stats", 2400.0, 2500.0),
                       event("sweep.reduce", 2600.0, 2700.0)])
    read = spec.metric_reader("sweep_host_ms.sweep")
    assert read(ctx) == pytest.approx(1.6 / 2)


def test_loop_refuses_a_program_without_the_sweeps_counters():
    """A program whose sweep keeps no counters (the parent's) is refused
    at set-up, before anything is built."""
    loop = spec.loop("sweep")
    bare = SimpleNamespace(_sweep_tick=lambda: None, run_sweep=lambda: None)
    with pytest.raises(RuntimeError, match="_sweep_tick.ticks"):
        loop.require(bare)
    from ironcub_mpc_tpu_torch.parallel import monte_carlo

    loop.require(monte_carlo)


def test_short_passes_run_and_check():
    """Passes of 4 ticks at 4 lanes through ``core/driver.py``: the
    flight's numbers step by step and chained, and the sweep's
    statistics."""
    d = {}
    res = driver.run(CELL, 2 ** 31 + 81, 0.5, False, device="cpu",
                     overrides=SHORT, detail=d)
    assert res["attempted"] >= 16 and res["failed"] == 0
    assert res["correct"], res["check"]
    stats = spec.loop("sweep").STATISTICS
    assert set(stats) | {"com_ref_m", "chain_com_ref_m"} <= set(res["check"])
    assert d["chained"] == SHORT["chain_ticks"] * SHORT["check_lanes"]
    assert all(p["n_ticks_retried"] == 0 for p in d["passes"])


def unpicked_retry(monkeypatch):
    """Every first solve reads failed, so every tick retries, and the
    retry's result is not kept: the commands stay the first solve's,
    spoilt."""
    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.parallel import monte_carlo
    from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop

    real = ClosedLoop.tick

    def tick(self, problem, carry, settings=None):
        new, tel = real(self, problem, carry, settings)
        if settings is None:
            tel = tel._replace(
                solver_status=torch.full_like(tel.solver_status,
                                              admm.MAX_ITER_REACHED),
                throttle=tel.throttle + 5.0)
        return new, tel
    tick.ticks = real.ticks
    monkeypatch.setattr(ClosedLoop, "tick", tick)
    monkeypatch.setattr(monte_carlo, "_pick", lambda mask, new, old: old)


def test_unpicked_retry_reads_incorrect(monkeypatch):
    unpicked_retry(monkeypatch)
    res = driver.run(CELL, 2 ** 31 + 82, 0.5, False, device="cpu",
                     overrides=SHORT)
    assert not res["correct"]
    assert res["check"]["throttle_pct"]["value"] > 1.0


def test_a_wrong_lane_com_error_reads_incorrect(monkeypatch):
    """The checked lanes' largest CoM error is held to the reference's own
    snapshots and CoM references: a sweep that reports every lane's 10 %
    high fails it."""
    from ironcub_mpc_tpu_torch.parallel import monte_carlo

    real = monte_carlo._reduce
    monkeypatch.setattr(monte_carlo, "_reduce", lambda mesh, acc, *a: real(
        mesh, acc._replace(max_err=acc.max_err * 1.1), *a))
    res = driver.run(CELL, 2 ** 31 + 84, 0.5, False, device="cpu",
                     overrides=SHORT)
    assert not res["correct"]
    got = res["check"]["lane_max_com_err_m"]
    assert got["value"] > got["limit"], got


@pytest.mark.gpu
def test_a_short_window_on_the_card(cuda_device):
    """A short pass at the cell's 1024 lanes on the card, traced: every new
    metric reads, the graphed shares read 100, the check holds."""
    over = dict(ticks=6, warm_passes=1, trace_ticks=6, check_ticks=3,
                chain_ticks=3, check_lanes=2)
    res = driver.run(CELL, 2 ** 31 + 83, 1.0, True, device=cuda_device,
                     overrides=over)
    assert res["correct"], res["check"]
    got = set(res["metrics"])
    assert set(READERS) <= got, set(READERS) - got
    for name in ("plant_graphed_share.sweep", "snapshot_graphed_share.sweep"):
        assert res["metrics"][name]["value"] == 100.0
    assert np.isfinite([m["value"] for m in res["metrics"].values()]).all()
