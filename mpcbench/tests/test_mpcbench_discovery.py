"""A later change adds a configuration, a traffic mix (with a stream), a
cell, a per-layer metric and a kernel's roofline count by adding files and
BENCHMARK.json entries alone: the harness finds each by its name. The
benchmark is copied to a temporary checkout, the new files are added there,
and a cell made of them runs on the CPU."""

import json
import shutil

import pytest

from mpcbench.core import driver, port, readers, spec, trace

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


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    bench_dir = tmp_path / "mpcbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = spec.benchmark()
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
    bench["workloads"].append(dict(name=cell, config="mk3_paper_h10",
                                   traffic="robot_b2", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if "mk3_paper.robot_b1" in m.get("workloads", ()):
            m["workloads"].append(cell)
    for name in readers:
        bench["per_layer"].append(dict(
            name=name, unit="1/tick", better="lower",
            source="program_counter", layer="kernels", moves="tick_ms",
            workloads=[cell]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "BENCHMARK", tmp_path / "BENCHMARK.json")
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
    cell = driver.Cell("mk3_paper.robot_b1", 2 ** 31 + 43, "cpu",
                       overrides=dict(warm_passes=0))
    calls = {}
    with port.instrument(calls):
        cell.run_pass("takeoff", [], [], n_ticks=2)
    assert set(calls) == set(port.KERNELS)
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
