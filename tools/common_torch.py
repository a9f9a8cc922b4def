"""Pieces the port's tools share: the card's line for a record, the refusal
to write over a committed record, and the two clocks a tool times with.

- :func:`device_entry` names the device of a record: on a card its name and
  power limit as ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` prints them, else the device type.
- :func:`writable` passes a path a tool may write, and refuses the
  committed records (``FLIGHT_r*.json``, ``SWEEP_r*.json``,
  ``MISMATCH*_r*.json`` and the other ``*_r<N>.json`` at the repository
  root) and anything under ``tests/golden/`` or ``data/``.
- :func:`host_ms` times on the host clock between two synchronisations;
  :func:`event_ms` times one stage's device work alone on CUDA events,
  the stream held busy ahead of them (the host clock on the CPU).
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COMMITTED_RECORD = re.compile(
    r"(FLIGHT|SWEEP|MISMATCH\w*|BENCH|RT|MULTICHIP)_r\d+\.json")
PROTECTED_DIRS = (ROOT / "tests" / "golden", ROOT / "data")


def card_line(index: int = 0) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[index]


def device_entry(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device type."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return dev.type
    return card_line(dev.index or 0)


def writable(path) -> Path:
    """``path`` as a Path, unless it names a committed record or lies under
    ``tests/golden/`` or ``data/``: then the tool exits with a refusal."""
    path = Path(path)
    full = path.resolve()
    if full.parent == ROOT and COMMITTED_RECORD.fullmatch(path.name):
        raise SystemExit(f"refusing to write over the committed record "
                         f"{path.name}; pass another --out")
    for d in PROTECTED_DIRS:
        if full == d or d in full.parents:
            raise SystemExit(f"refusing to write into {d.relative_to(ROOT)}/ "
                             f"({path}); pass another --out")
    return path


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int, warmup: int = 1) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls, timed between
    two synchronisations after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(stop)


def event_ms(fn, dev, reps: int, warmup: int = 1) -> float:
    """Mean device ms of ``fn()`` alone: CUDA events around ``reps``
    back-to-back calls on a card, the host clock between synchronisations
    on the CPU. A call's host work can outlast a short kernel, so the
    stream is first held busy for twice the host time of the ``reps``
    calls (as ``chip_smoke.py``'s ``cuda_ms``): the events then see the
    calls queued back to back and time the device alone."""
    if torch.device(dev).type != "cuda":
        return host_ms(fn, dev, reps, warmup)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    call_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(dev)
    if not hasattr(event_ms, "cycles_per_ms"):
        event_ms.cycles_per_ms = _sleep_cycles_per_ms()
    hold_ms = min(2.0 * reps * call_ms, 2000.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * event_ms.cycles_per_ms))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def batched_hover(batch: int, settings=None, device=None, cfg=None,
                  jitter: float = 0.1, seed: int = 0):
    """The hover problem of ``examples/realtime_driver_torch.hover_setup``
    with its one-lane carry and snapshot repeated ``batch`` times, each
    lane's momentum perturbed by ``jitter`` times a normal draw of numpy's
    generator ``seed``. Returns (cfg, sched, sel, settings, problem,
    carries, snaps, est) with ``est`` zero [batch, 4]."""
    import numpy as np

    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    from realtime_driver_torch import hover_setup

    from ironcub_mpc_tpu_torch.core.types import expand_lanes

    cfg, sched, sel, settings, problem, carry, snap = hover_setup(
        settings=settings, device=device, cfg=cfg)
    dev = carry.warm_x.device
    carries = expand_lanes(carry, batch)
    snaps = expand_lanes(snap, batch)
    noise = np.random.default_rng(seed).standard_normal((batch, 6))
    snaps = snaps._replace(momentum_body=snaps.momentum_body + torch.as_tensor(
        jitter * noise, dtype=snaps.momentum_body.dtype, device=dev))
    est = torch.zeros((batch, 4), dtype=torch.float32, device=dev)
    return cfg, sched, sel, settings, problem, carries, snaps, est


def option(argv, name, default=None):
    """The value after ``--name`` in ``argv``, else ``default``."""
    flag = f"--{name}"
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
    return default


def positional(argv, valued=("out", "device")):
    """The arguments of ``argv`` that are neither options nor the value of
    one of the ``valued`` options."""
    flags = {f"--{v}" for v in valued}
    return [a for i, a in enumerate(argv) if not a.startswith("--")
            and (i == 0 or argv[i - 1] not in flags)]
