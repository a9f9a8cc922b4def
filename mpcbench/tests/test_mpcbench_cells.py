"""Every cell of BENCHMARK.json end to end on the CPU, through the kernels'
plain twins, at a tiny window: the result carries the contract's keys, the
cell's own metrics, and the check against the float64 reference. Also the
command's refusal without a card."""

import json
import subprocess
import sys

import pytest

from mpcbench.core import driver, spec

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def tiny(name):
    """A window the CPU holds: at most 4 lanes, no warm pass, 2 traced
    ticks a stream."""
    traffic = json.loads(spec.traffic_path(
        spec.workload(spec.benchmark(), name)["traffic"]).read_text())
    lanes = min(4, traffic["lanes"])
    return dict(lanes=lanes, check_lanes=min(lanes, traffic["check_lanes"]),
                warm_passes=0, trace_ticks=2)


@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(name):
    res = driver.run(name, 2 ** 31 + 11, 1.0, False, device="cpu",
                     overrides=tiny(name))
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "check"
    bench = spec.benchmark()
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.end_to_end(bench, name)}
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced(name):
    res = driver.run(name, 2 ** 31 + 12, 1.0, True, device="cpu",
                     overrides=tiny(name))
    assert list(res)[:5] == list(KEYS)
    # on the CPU only the counters read: no device trace
    allowed = {m["name"] for m in spec.per_layer(spec.benchmark(), name)
               if m["source"] == "program_counter"}
    assert set(res["metrics"]) <= allowed
    assert res["correct"], res["check"]


def test_same_seed_same_inputs():
    from mpcbench.core import traffic

    t = traffic.load(spec.traffic_path("lanes_b1024"))
    draw = spec.loop(t["loop"]).draw
    a, b = draw(t, 2 ** 31 + 5), draw(t, 2 ** 31 + 5)
    assert (a.jitter == b.jitter).all()
    assert (a.check_lanes == b.check_lanes).all()
    c = draw(t, 2 ** 31 + 6)
    assert a.jitter.shape == c.jitter.shape and (a.jitter != c.jitter).any()


def test_command_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "mpcbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
