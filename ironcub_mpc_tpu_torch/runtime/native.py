"""ctypes bindings to the native runtime library (``native/ironcub_rt.cc``;
counterpart of ``ironcub_mpc_tpu/runtime/native.py``).

The host-side real-time pieces as native code — the role C++ plays in the
reference's runtime:

- :class:`TelemetryRing`: lock-free SPSC ring of float records, drained to
  disk off the control thread;
- :class:`RealtimePacer`: absolute-deadline loop pacing with overrun
  accounting (clock_nanosleep under the hood).

The library is compiled at first use by the host C++ compiler (``g++`` on
PATH; no cmake) into ``build/torch_native/libironcub_rt_<tag>.so``, the tag
a hash of source and flags, written to a temporary file and renamed into
place so a concurrent build never loads a half-written library. A failed
build raises with the compiler's log. ``python -m
ironcub_mpc_tpu_torch.runtime.native --build`` builds it ahead of time.

The pure-Python ring and pacer remain for a caller that sets ``_LIB`` to
None on purpose (the fallback test); a failed build never turns into them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "ironcub_rt.cc"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-Wall", "-std=c++17", "-shared", "-fPIC", "-pthread")

_UNLOADED = object()
# the loaded library; None selects the pure-Python fallback
_LIB = _UNLOADED


def lib_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libironcub_rt_{tag}.so"


def build(verbose: bool = False) -> Path:
    """Compile the native library unless this source and these flags are
    built already; returns its path. Raises with the compiler's log."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) on PATH to build "
                           f"{SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                           f"{res.stdout}{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, out)
    return out


def _load():
    lib = ctypes.CDLL(str(build()))
    p, sz, u64, i64 = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,
                       ctypes.c_int64)
    fptr = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "ring_create": (p, [sz, sz]),
        "ring_destroy": (None, [p]),
        "ring_push": (ctypes.c_int, [p, fptr]),
        "ring_pop": (sz, [p, fptr, sz]),
        "ring_dropped": (u64, [p]),
        "ring_size": (sz, [p]),
        "ring_drain_to_file": (sz, [p, ctypes.c_char_p]),
        "pacer_create": (p, [ctypes.c_double]),
        "pacer_destroy": (None, [p]),
        "pacer_wait": (i64, [p]),
        "pacer_overruns": (u64, [p]),
        "pacer_worst_late_ns": (i64, [p]),
        "pacer_ticks": (u64, [p]),
        "monotonic_ns": (i64, []),
        "ring_stress": (ctypes.c_int, [sz, sz, u64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _lib():
    """The native library, built and loaded at first use (None only where
    a caller set ``_LIB`` to None)."""
    global _LIB
    if _LIB is _UNLOADED:
        _LIB = _load()
    return _LIB


def available() -> bool:
    """True once the native library is loaded (building it at first use);
    False only where ``_LIB`` was set to None on purpose."""
    return _lib() is not None


def ring_stress(capacity: int, record_len: int, n_records: int) -> int:
    """Run the native concurrent SPSC stress (real producer vs consumer
    thread; ctypes releases the GIL for the call's duration). Returns 0 on
    success — see ironcub_rt.cc ring_stress for the error codes."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("ring_stress needs the native library")
    return int(lib.ring_stress(capacity, record_len, n_records))


class TelemetryRing:
    """SPSC float-record ring (deque fallback where ``_LIB`` is None)."""

    def __init__(self, capacity: int, record_len: int):
        self.record_len = record_len
        self._lib = _lib()
        if self._lib is not None:
            self._h = self._lib.ring_create(capacity, record_len)
        else:
            from collections import deque

            self._q = deque(maxlen=capacity)
            self._dropped = 0
            self._capacity = capacity

    def push(self, record) -> bool:
        rec = np.ascontiguousarray(record, np.float32)
        if rec.size != self.record_len:
            raise ValueError(f"record of {rec.size} floats, the ring holds "
                             f"{self.record_len}")
        if self._lib is not None:
            ptr = rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return bool(self._lib.ring_push(self._h, ptr))
        if len(self._q) >= self._capacity:
            self._dropped += 1
            return False
        self._q.append(rec.copy())
        return True

    def pop(self, max_records: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty((max_records, self.record_len), np.float32)
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            n = self._lib.ring_pop(self._h, ptr, max_records)
            return out[:n]
        out = []
        while self._q and len(out) < max_records:
            out.append(self._q.popleft())
        return (np.stack(out) if out
                else np.empty((0, self.record_len), np.float32))

    @property
    def size(self) -> int:
        return (self._lib.ring_size(self._h) if self._lib is not None
                else len(self._q))

    @property
    def dropped(self) -> int:
        return (self._lib.ring_dropped(self._h) if self._lib is not None
                else self._dropped)

    def drain_to_file(self, path: str) -> int:
        if self._lib is not None:
            return self._lib.ring_drain_to_file(self._h, str(path).encode())
        recs = self.pop(1 << 30)
        with open(path, "ab") as f:
            recs.tofile(f)
        return len(recs)

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.ring_destroy(self._h)


class RealtimePacer:
    """Absolute-deadline period pacing with overrun accounting."""

    def __init__(self, period_s: float):
        self.period = period_s
        self._lib = _lib()
        if self._lib is not None:
            self._h = self._lib.pacer_create(period_s)
        else:
            self._next = time.monotonic() + period_s
            self._overruns = 0
            self._worst = 0.0
            self._ticks = 0

    def wait(self) -> float:
        """Block until the next deadline; returns lateness in seconds
        (negative = slack)."""
        if self._lib is not None:
            return self._lib.pacer_wait(self._h) * 1e-9
        late = time.monotonic() - self._next
        if late < 0:
            time.sleep(-late)
        else:
            self._overruns += 1
            self._worst = max(self._worst, late)
        self._ticks += 1
        self._next += self.period
        return late

    @property
    def overruns(self) -> int:
        return (self._lib.pacer_overruns(self._h) if self._lib is not None
                else self._overruns)

    @property
    def worst_lateness(self) -> float:
        return (self._lib.pacer_worst_late_ns(self._h) * 1e-9
                if self._lib is not None else self._worst)

    @property
    def ticks(self) -> int:
        return (self._lib.pacer_ticks(self._h) if self._lib is not None
                else self._ticks)

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.pacer_destroy(self._h)


if __name__ == "__main__":
    if "--build" in sys.argv:
        print("built:", build(verbose=True))
    else:
        print("native runtime available:", available())
