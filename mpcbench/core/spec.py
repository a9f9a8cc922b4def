"""Finds everything a run needs by the names in ``BENCHMARK.json``.

Each item sits in a file of its own under ``mpcbench/``, so that a later
change adds a cell, a configuration, a traffic mix, a per-layer metric or a
kernel's roofline count by adding files and entries, never by editing one:

- ``cells/<workload>.json``: the limits of the cell's correctness check;
- ``configs/<config>.json``: the deployment (``file`` in ``BENCHMARK.json``);
- ``traffic/<traffic>.json``: the mix, read by ``core/traffic.py``;
- ``loops/<loop>.py``: the loop that drives a mix, named by its ``loop``
  key (``replay`` where it names none): its keys, set-up, passes and check;
- ``streams/<stream>.npz``: a recorded plant stream a mix names, or other
  data a loop loads;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
- ``roofline/<kernel>.py``: a kernel's operations and bytes a call, with
  ``roofline/peaks.json`` the card's published peaks.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config_path(bench: dict, name: str) -> Path:
    return ROOT / _named(bench["configs"], name, "configuration")["file"]


def config(bench: dict, name: str) -> dict:
    return json.loads(config_path(bench, name).read_text())


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def stream_path(name: str) -> Path:
    return BENCH_DIR / "streams" / f"{name}.npz"


def cell(name: str) -> dict:
    return json.loads((BENCH_DIR / "cells" / f"{name}.json").read_text())


def _reports(metric: dict, wl_name: str, e2e_of_cell) -> bool:
    if "workloads" in metric:
        return wl_name in metric["workloads"]
    return metric.get("moves") in e2e_of_cell


def end_to_end(bench: dict, wl_name: str) -> list:
    """The cell's end-to-end metrics: those that list it, and those that
    list no cell."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or wl_name in m["workloads"]]


def per_layer(bench: dict, wl_name: str) -> list:
    """The cell's per-layer metrics: those that list it, and those that list
    no cell and move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, wl_name)}
    return [m for m in bench["per_layer"] if _reports(m, wl_name, e2e)]


def _module(path: Path, prefix: str):
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py",
                   "mpcbench_metric_").read


def loop(name: str):
    """The module ``loops/<name>.py``: ``KEYS`` and ``Loop``
    (``loops/__init__.py`` sets out what a loop provides)."""
    return _module(BENCH_DIR / "loops" / f"{name}.py", "mpcbench_loop_")


def roofline(kernel: str):
    """The module ``roofline/<kernel>.py``: ``KERNEL_NAMES`` and
    ``work(call) -> (operations, bytes)``."""
    return _module(BENCH_DIR / "roofline" / f"{kernel}.py",
                   "mpcbench_roofline_")


def peaks() -> dict:
    return json.loads((BENCH_DIR / "roofline" / "peaks.json").read_text())
