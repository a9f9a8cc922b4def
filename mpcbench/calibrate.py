"""Reads the numbers a cell's correctness check compares, over many seeds
in one process, for the program as configured and for a control.

    python3 mpcbench/calibrate.py --workload <name> --seeds 101-112 \
        [--control none|tf32emu|kbf16|tf32] [--seconds 6] [--out calib.jsonl]
    python3 mpcbench/calibrate.py --workload <name> --seeds 101-112 --lead-in

Each seed is one run of the cell (``mpcbench/core/driver.py``) with no warm
pass and a window of ``--seconds``, long enough to replay every stream of
the mix once. The controls, each the program with a precision lowered below the float32
with TF32 off that the configuration states:

- ``tf32``, the control: PyTorch's own TF32 switch
  (``torch.backends.cuda.matmul.allow_tf32``), the program's own path to
  the nearest precision below; cuBLAS takes it where it picks a
  tensor-core kernel (most batched products, few at batch 1).
- ``tf32emu`` rounds both operands of every float32 product the program
  makes through PyTorch (``@``, ``matmul``, ``einsum``) to TF32's 10-bit
  mantissa (to nearest), on any device: TF32 in every such product, the
  hand-written kernels left in float32.
- ``kbf16`` rounds K^-1 and every vector handed to a hand-written kernel,
  and every tensor it returns, to bfloat16 (to nearest) around each kernel
  call: the kernels' own inputs and outputs in half precision, the rest of
  the tick in float32.

A number's upper reading is the smallest that the controls give where that
is three times its sound one or more (``PERF.md`` §6).

``--lead-in`` reads set-up's lead-in alone instead: each stream's first
ticks from ``configure``'s carry, every lane's solver status, and the
checked lanes' widest gaps to the reference's own first ticks.

Prints one JSON line a seed (the numbers compared, the statuses, the
seconds) and writes the same lines to ``--out``. The limits in
``mpcbench/cells/`` are set from these readings, as ``PERF.md`` records;
the benchmark's own runs never run a control.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def tf32(torch, x):
    """``x`` with a float32 tensor's mantissa rounded to TF32's 10 bits."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)
    return x


@contextlib.contextmanager
def tf32_products(torch):
    """Within the block every float32 product made through ``@``,
    ``matmul`` or ``einsum`` takes TF32-rounded operands."""
    saved = (torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.Tensor.matmul, torch.matmul, torch.einsum)
    mm, rmm, tmm, matmul, einsum = saved

    def r(x):
        return tf32(torch, x)

    torch.Tensor.__matmul__ = lambda a, b: mm(r(a), r(b))
    torch.Tensor.__rmatmul__ = lambda a, b: rmm(r(a), r(b))
    torch.Tensor.matmul = lambda a, b: tmm(r(a), r(b))
    torch.matmul = lambda a, b, **kw: matmul(r(a), r(b), **kw)
    torch.einsum = lambda eq, *ops: einsum(eq, *(r(o) for o in ops))
    try:
        yield
    finally:
        (torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
         torch.Tensor.matmul, torch.matmul, torch.einsum) = saved


@contextlib.contextmanager
def bf16_kernels(torch):
    """Within the block every kernel wrapper of the port (found by its
    launch counter) takes and returns its float32 tensors rounded to
    bfloat16."""
    from mpcbench.core import port

    def r(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def make(name, f):
        def call(*args, **kwargs):
            out = f(*(r(a) for a in args),
                    **{k: r(v) for k, v in kwargs.items()})
            return tuple(r(o) for o in out) if isinstance(out, tuple) \
                else r(out)
        return call

    with port.wrapped("launches", make):
        yield


@contextlib.contextmanager
def tf32_switch(torch):
    """Within the block PyTorch's TF32 switch is on (after the port's
    import, which pins it off)."""
    from mpcbench.core import port

    port.load()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


CONTROLS = {"tf32": tf32_switch, "tf32emu": tf32_products,
            "kbf16": bf16_kernels}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control", choices=("none", *CONTROLS), default="none")
    p.add_argument("--lead-in", action="store_true")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from mpcbench.core import driver, port

    torch.set_num_threads(2)
    port.load()

    control = (contextlib.nullcontext() if args.control == "none"
               else CONTROLS[args.control](torch))
    with control:
        lines = (lead_in_readings if args.lead_in else readings)(driver,
                                                                 args)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


def lead_in_readings(driver, args) -> list:
    """One JSON line a seed: the lead-in's statuses and gaps."""
    import numpy as np
    import torch

    from mpcbench.core import check, spec
    from mpcbench.reference import chain

    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = driver.Cell(args.workload, seed, args.device,
                           overrides=dict(warm_passes=0))
        replay = cell.loop
        gaps = {}
        for s, rows in replay.start.items():
            worst = {name: 0.0 for name in check.GROUPS}
            for j, lane in enumerate(replay.draw.check_lanes):
                ref = chain.run_lane(cell.config_path, spec.stream_path(s),
                                     replay.draw.jitter[lane], 0, None,
                                     replay.lead_in)
                check._widest(worst, "", np.asarray(rows[j], np.float64),
                              {k: v[-1] for k, v in ref.items()})
            gaps[s] = worst
        row = dict(workload=args.workload, control=args.control, seed=seed,
                   lead_in=driver.lead_in_statuses(cell), gaps=gaps,
                   seconds=time.perf_counter() - t0)
        del cell, replay
        if args.device == "cuda":
            torch.cuda.empty_cache()
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    return lines


def readings(driver, args) -> list:
    """One JSON line of readings a seed."""
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        try:
            detail = {}
            res = driver.run(args.workload, seed, args.seconds, False,
                             device=args.device,
                             overrides=dict(warm_passes=0), detail=detail)
            row = dict(workload=args.workload, control=args.control,
                       seed=seed, attempted=res["attempted"],
                       failed=res["failed"], lead_in=res["lead_in"],
                       cases=detail["cases"], chained=detail["chained"],
                       numbers=detail["numbers"],
                       metrics={k: v["value"]
                                for k, v in res["metrics"].items()})
        except Exception as exc:  # a control that crashes has failed
            row = dict(workload=args.workload, control=args.control,
                       seed=seed, error=repr(exc)[:500])
        row["seconds"] = time.perf_counter() - t0
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    return lines


if __name__ == "__main__":
    sys.exit(main())
