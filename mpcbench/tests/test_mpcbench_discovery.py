"""A later change adds a configuration, a traffic mix (with a stream), a
cell, a per-layer metric, a kernel's roofline count and a loop that drives
its mix by adding files and BENCHMARK.json entries alone: the harness finds
each by its name. The benchmark is copied to a temporary checkout, the new
files are added there, and a cell made of them runs on the CPU."""

import json
import shutil

import pytest

from mpcbench.core import driver, port, readers, spec, trace

ROOT = spec.ROOT

NEW_READER = '''
def read(ctx):
    calls = ctx["calls"].get("admm_segment", [])
    return len(calls) / ctx["ticks"]
'''
# the counters and the raw events, read in a way no reader of the
# benchmark reads them yet
COUNTER_READER = '''
def read(ctx):
    c = ctx["counters"]
    assert "ops.kernels.admm_segment.launches" in c
    return sum(v for k, v in c.items() if k.endswith(".syncs")) / ctx["ticks"]
'''
EVENTS_READER = '''
def read(ctx):
    ticks = [e for e in ctx["events"] if e.name == "mpc_tick"]
    return sum(e.cpu_time_total for e in ticks) / 1e3 / ctx["ticks"]
'''
NEW_ROOFLINE = '''
KERNEL_NAMES = ("new_kernel_",)


def work(call):
    B, P = call["shapes"][0][0], call["shapes"][0][-1]
    return 2 * B * P ** 2, 4 * B * P ** 2
'''

# a loop of its own: the port's closed loop (runtime/loop.py ClosedLoop.tick:
# the snapshot, an mpc_tick, the commands, five 1 kHz plant substeps) at the
# mix's lanes with direct thrust, every pass from a recorded plant state
CLOSED_LOOP = '''
import time

import numpy as np
import torch

from mpcbench.core import driver, port, spec

KEYS = ("start", "ticks")
KERNELS = ("admm_segment", "woodbury_ns")


class Loop:
    def __init__(self, cell, seed):
        from ironcub_mpc_tpu_torch.core.config import RobotConfig, SimConfig
        from ironcub_mpc_tpu_torch.dynamics import KinDyn, load_ironcub_model
        from ironcub_mpc_tpu_torch.runtime.loop import ClosedLoop
        from ironcub_mpc_tpu_torch.sim.plant import Plant

        self.dev, self.per_tick = cell.dev, cell.per_tick
        ctl = port.build(cell.config, dict(decisions="per_lane"))
        kd = KinDyn(load_ironcub_model(), device=self.dev)
        robot = RobotConfig(axes_list=tuple(cell.config["robot"]["axes_list"]))
        plant = Plant(kd, robot, SimConfig(use_nn_jet_dynamics=False))
        self.loop = ClosedLoop(plant, ctl.cfg, ctl.settings)
        if self.dev.type == "cuda":
            port.build_kernels(KERNELS)
        z = np.load(spec.stream_path(cell.traffic["start"]))

        def lanes(a):
            t = torch.as_tensor(a, dtype=kd.dtype, device=self.dev)
            return t.expand(cell.lanes, *t.shape).clone()

        s = plant.init_state(z["state_base_R"][0], z["state_base_p"][0],
                             z["state_q"][0], seed=seed, batch=cell.lanes)
        s = s._replace(base_v=lanes(z["state_base_vel"][0]),
                       qd=lanes(z["state_qd"][0]),
                       thrust_cmd=lanes(z["state_thrust"][0]),
                       throttle=lanes(z["initial_throttle"]))
        channels = {k[3:]: z[k] for k in z.files if k.startswith("ch_")}
        self.problem, carry = self.loop.configure(s, channels, z["alpha"])
        # from configure's cold carry the first tick does not converge: a
        # lead-in tick in set-up, and every pass starts after it
        self.start, tel = self.loop.tick(self.problem, carry)
        self.lead_in_status = {"flight": [tel.solver_status]}
        self.noise = plant.noise_state()
        self.ticks = int(cell.traffic["ticks"])
        self.passes = ["flight"]

    def run_pass(self, name, records, statuses, n_ticks=None,
                 latencies=None, deadline=None, span=None):
        from ironcub_mpc_tpu_torch.core.types import tree_map

        span = span or driver.NOSPAN
        carry = tree_map(torch.clone, self.start)
        self.loop.plant.set_noise_state(self.noise)
        n = self.ticks if n_ticks is None else min(n_ticks, self.ticks)
        for t in range(n):
            t1 = time.perf_counter()
            with span("mpc_tick"):
                carry, tel = self.loop.tick(self.problem, carry)
            with span("commands"):
                rows = torch.cat((tel.joints_pos_ref, tel.throttle,
                                  tel.base_position), dim=1)
                if self.per_tick:
                    rows = rows.cpu()
            t2 = time.perf_counter()
            records.append((name, t, rows))
            statuses.append(tel.solver_status)
            if latencies is not None:
                latencies.append(t2 - t1)
            if deadline is not None and self.per_tick and t2 >= deadline:
                return False
        return True

    def check(self, records, statuses, detail=None):
        rows = [r.cpu() for _, _, r in records]
        records.clear()
        statuses.clear()
        self.start = None
        return dict(nonfinite=sum(int((~torch.isfinite(r)).sum())
                                  for r in rows))
'''
TICK_SPANS_READER = '''
def read(ctx):
    ticks = [e for e in ctx["events"] if e.name == "mpc.tick"]
    return len(ticks) / ctx["ticks"] if ticks else None
'''


def copy_benchmark(tmp_path):
    """A temporary checkout holding the benchmark without its tests:
    (its mpcbench directory, BENCHMARK.json as a dict)."""
    bench_dir = tmp_path / "mpcbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return bench_dir, spec.benchmark()


def point_spec_at(tmp_path, bench, monkeypatch):
    """Writes ``bench`` into the temporary checkout and makes the harness
    read that checkout."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path / "mpcbench")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "BENCHMARK", tmp_path / "BENCHMARK.json")


def add_cell(bench, cell, config, traffic, e2e, metrics):
    """``cell`` in ``bench``, reporting the end-to-end metrics ``e2e`` (each
    of which lists its cells) and the per-layer ``metrics``."""
    bench["workloads"].append(dict(name=cell, config=config,
                                   traffic=traffic, chips=1, why="test"))
    for m in bench["end_to_end"]:
        if m["name"] in e2e:
            m["workloads"].append(cell)
    for name in metrics:
        bench["per_layer"].append(dict(
            name=name, unit="1/tick", better="lower",
            source="program_counter", layer="kernels", moves="tick_ms",
            workloads=[cell]))


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    bench_dir, bench = copy_benchmark(tmp_path)
    config = json.loads((bench_dir / "configs" / "mk3_paper.json").read_text())
    config["name"] = "mk3_paper_h10"
    config["mpc"]["control_horizon"] = 10
    (bench_dir / "configs" / "mk3_paper_h10.json").write_text(
        json.dumps(config))
    shutil.copy(bench_dir / "streams" / "takeoff.npz",
                bench_dir / "streams" / "takeoff_again.npz")
    mix = json.loads((bench_dir / "traffic" / "robot_b1.json").read_text())
    mix.update(lanes=2, check_lanes=2, streams=["takeoff_again"],
               decisions="batch_wide", warm_passes=0, trace_ticks=2)
    (bench_dir / "traffic" / "robot_b2.json").write_text(json.dumps(mix))
    cell = "mk3_paper_h10.robot_b2"
    (bench_dir / "cells" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"joints_rad": 1.0, "throttle_pct": 5.0, "thrust_N": 1.0,
                    "thrust_rate_Nps": 10.0, "nonfinite": 0}}))
    readers = {"segment_calls_per_tick.new": NEW_READER,
               "readbacks_per_tick.new": COUNTER_READER,
               "tick_host_ms.new": EVENTS_READER}
    for name, text in readers.items():
        (bench_dir / "metrics" / f"{name}.py").write_text(text)
    (bench_dir / "roofline" / "new_kernel.py").write_text(NEW_ROOFLINE)
    bench["configs"].append(dict(
        name="mk3_paper_h10", source="https://example.org/h10",
        file="mpcbench/configs/mk3_paper_h10.json", reduced=[], why="test"))
    add_cell(bench, cell, "mk3_paper_h10", "robot_b2",
             [m["name"] for m in bench["end_to_end"]
              if "mk3_paper.robot_b1" in m.get("workloads", ())], readers)
    point_spec_at(tmp_path, bench, monkeypatch)
    return cell


@pytest.fixture
def closed_checkout(tmp_path, monkeypatch):
    """A closed-loop cell added by files alone: a loop, a mix that names it,
    its starting state (the recorded plant state at the fixture's
    ``meta_start_tick``), the cell, its limits and a reader."""
    bench_dir, bench = copy_benchmark(tmp_path)
    (bench_dir / "loops" / "closed.py").write_text(CLOSED_LOOP)
    shutil.copy(ROOT / "tests" / "torch_fixtures" / "plant_states_takeoff.npz",
                bench_dir / "streams" / "takeoff_states.npz")
    (bench_dir / "traffic" / "closed_b1.json").write_text(json.dumps(dict(
        loop="closed", lanes=1, commands_to_host="every_tick",
        start="takeoff_states", ticks=3, trace_ticks=3)))
    cell = "mk3_paper.closed_b1"
    (bench_dir / "cells" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"nonfinite": 0}}))
    (bench_dir / "metrics" / "tick_spans_per_tick.new.py").write_text(
        TICK_SPANS_READER)
    add_cell(bench, cell, "mk3_paper", "closed_b1",
             ("tick_ms", "tick_ms_p95"), ["tick_spans_per_tick.new"])
    point_spec_at(tmp_path, bench, monkeypatch)
    return cell


def test_new_cell_runs_from_new_files(checkout):
    res = driver.run(checkout, 2 ** 31 + 41, 0.5, False, device="cpu")
    assert set(res["metrics"]) == {"tick_ms", "tick_ms_p95", "setup_s"}
    assert res["attempted"] > 0 and res["correct"], res["check"]


def test_new_metric_reader_is_read(checkout):
    res = driver.run(checkout, 2 ** 31 + 42, 0.5, True, device="cpu")
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["segment_calls_per_tick.new"] > 0
    assert m["readbacks_per_tick.new"] > 0
    assert m["tick_host_ms.new"] > 0


def test_closed_loop_cell_runs_from_new_files(closed_checkout):
    """A mix that names a loop of its own runs through the driver: the
    window's end-to-end metrics untraced, the port's ``mpc.tick`` spans
    traced, its check's number against its limit."""
    res = driver.run(closed_checkout, 2 ** 31 + 44, 0.5, False, device="cpu")
    assert set(res["metrics"]) == {"tick_ms", "tick_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert res["correct"], res["check"]
    assert res["check"] == {"nonfinite": {"value": 0, "limit": 0}}
    res = driver.run(closed_checkout, 2 ** 31 + 45, 0.5, True, device="cpu")
    assert res["metrics"]["tick_spans_per_tick.new"]["value"] == 1.0
    assert res["attempted"] == 3 and res["correct"], res["check"]


def test_new_kernel_wrapper_is_recorded(monkeypatch):
    """A kernel wrapper the program adds later (a function of its own that
    counts its ``launches``) is recorded and counted by the traced run
    with no edit of the harness: its arguments' shapes and keywords, its
    launches handed back after the window."""
    import torch
    from ironcub_mpc_tpu_torch.ops import kernels

    def new_kernel(Kinv, v, *, n_box, sigma):
        new_kernel.launches += 1
        return Kinv @ v[..., None]

    new_kernel.launches = 0
    new_kernel.__module__ = kernels.__name__
    monkeypatch.setattr(kernels, "new_kernel", new_kernel, raising=False)
    calls = {}
    before = port.counters()["ops.kernels.new_kernel.launches"]
    with port.instrument(calls):
        kernels.new_kernel(torch.ones(2, 8, 8), torch.ones(2, 8), n_box=3,
                           sigma=1e-6)
    assert calls["new_kernel"] == [dict(shapes=[(2, 8, 8), (2, 8)],
                                        n_box=3, sigma=1e-6)]
    assert kernels.new_kernel is new_kernel
    assert port.counters()["ops.kernels.new_kernel.launches"] == before + 1


def test_tick_calls_give_the_roofline_counts():
    """The calls a traced tick records carry what each kernel's roofline
    count reads."""
    replay = driver.Cell("mk3_paper.robot_b1", 2 ** 31 + 43, "cpu",
                         overrides=dict(warm_passes=0)).loop
    calls = {}
    with port.instrument(calls):
        replay.run_pass("takeoff", [], [], n_ticks=2)
    assert set(calls) == set(spec.loop("replay").KERNELS)
    for kernel, cs in calls.items():
        for c in cs:
            ops, nbytes = spec.roofline(kernel).work(c)
            assert ops > 0 and nbytes > 0


def test_new_roofline_count_is_found(checkout):
    tr = trace.Trace(start_us=0.0, end_us=1e6, window_s=1.0, busy_s=0.5,
                     kernels=[("void new_kernel_a<1>(float*)", 2e-6),
                              ("other", 1.0)],
                     device_ops=[], idle_gaps=[])
    ctx = dict(trace=tr, calls={"new_kernel": [dict(shapes=[(1, 128, 128)])]},
               roofline=spec.roofline, peaks=spec.peaks())
    share = readers.roofline_share(ctx, "new_kernel")
    least = 4 * 128 ** 2 / spec.peaks()["hbm_bytes_per_s"]
    assert share == pytest.approx(100 * least / 2e-6)
