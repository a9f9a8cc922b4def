"""The port's bench (bench_torch.py) on the CPU at a small size.

Its JSON line has bench.py's keys in bench.py's order (read out of
bench.py's ``result = {...}`` with ``ast``: bench.py imports JAX) and then
``device``; its chained throughput loop is the port's ``mpc_tick`` and
nothing else; and BENCH_MESH=1 over two ``gloo`` processes prints one line
from rank 0. Batch 2, 3 chained ticks, 1 per-dispatch tick.
"""

import ast
import contextlib
import functools
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_tick import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(BENCH_BATCH="2", BENCH_SCAN="3", BENCH_ITERS="1")


def bench_py_keys():
    """The keys of bench.py's ``result`` dict literal, in order."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "result"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no result = {...}")


@functools.lru_cache(maxsize=None)
def run_bench(static: bool):
    """(stdout, returned line) of bench_torch.main on the CPU, once per
    regime."""
    env = dict(SMALL, BENCH_STATIC="1" if static else "0", BENCH_MESH="0")
    out = io.StringIO()
    with mock.patch.dict(os.environ, env), contextlib.redirect_stdout(out):
        result, _ = bench_torch.main(["--device", "cpu"])
    return out.getvalue(), result


def json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("static", [False, True],
                         ids=["flight_replay", "static"])
def test_bench_prints_one_line_with_bench_py_keys(static):
    stdout, result = run_bench(static)
    lines = json_lines(stdout)
    assert len(lines) == 1 and len(stdout.splitlines()) == 1, stdout
    line = lines[0]
    assert line == result
    assert list(line) == bench_py_keys() + ["device"]
    assert line["metric"] == "mpc_solves_per_s"
    assert line["unit"] == "solves/s"
    assert line["regime"] == ("static" if static else "flight_replay")
    assert line["device"] == "cpu"
    assert line["deadline_ms"] == 5.0
    for k, v in line.items():
        if isinstance(v, float):
            assert np.isfinite(v) and v > 0, (k, v)
    assert line["solved_frac"] == 1.0
    # 200 solves/s, one solve per 5 ms tick, not BASELINE.json's 5,000
    assert line["vs_baseline"] == pytest.approx(line["value"] / 200.0,
                                                abs=1e-3)


def test_throughput_chain_is_mpc_tick_and_nothing_else():
    """The bench's chained loop at batch 2 over 3 ticks gives the statuses
    and final states of direct mpc_tick calls on the same inputs, exactly."""
    from ironcub_mpc_tpu_torch.core.types import expand_lanes
    from ironcub_mpc_tpu_torch.qp import mpc
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    batch, n = 2, 3
    replay = load_flight_replay(device="cpu")
    settings = bench_torch.bench_settings(1e-3, batch_guard=True)
    problem, carry = replay.configure(settings)
    jitter = torch.as_tensor(bench_torch.lane_jitter(batch))
    tick = bench_torch.make_tick(replay, settings, problem)
    inputs = bench_torch.stream_inputs(replay, n, batch, jitter)
    end, outs = bench_torch.chain(tick, expand_lanes(carry, batch), inputs)

    c = expand_lanes(carry, batch)
    for t in range(n):
        snap, est = replay.tick_inputs(t, batch, jitter)
        c, want = mpc.mpc_tick(replay.cfg, replay.sched, replay.sel,
                               settings, problem, c, snap, est)
        assert torch.equal(outs[t].status, want.status), t
        assert torch.equal(outs[t].final_state, want.final_state), t
        assert torch.equal(outs[t].throttle, want.throttle), t
    assert torch.equal(end.warm_x, c.warm_x)
    assert bench_torch.solved_frac(outs) == 1.0


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bench_mesh_over_two_gloo_ranks():
    """BENCH_MESH=1 over two processes (one lane each): rank 0 prints the
    one line, rank 1 none, and every lane-tick solves, as in the
    single-process run."""
    env = dict(os.environ, **SMALL, BENCH_MESH="1", BENCH_STATIC="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "bench_torch.py", "--device", "cpu"], cwd=ROOT,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines0, lines1 = (json_lines(o) for o, _ in outs)
    assert lines1 == []
    assert len(lines0) == 1
    line = lines0[0]
    assert list(line) == bench_py_keys() + ["device"]
    assert "# BENCH_MESH: 2 processes, 1 scenarios/process" in outs[0][1]
    assert line["solved_frac"] == run_bench(False)[1]["solved_frac"] == 1.0
    for k, v in line.items():
        if isinstance(v, float):
            assert np.isfinite(v) and v > 0, (k, v)
