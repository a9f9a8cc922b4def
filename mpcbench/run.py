"""Runs one cell of the port's benchmark once and prints its result line.

    python3 mpcbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``. With ``--trace 0``
the line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a ``torch.profiler`` trace. Its last key,
``check``, gives each number compared with the reference of the loop that
drives the cell's mix beside its limit, and the same lines end standard
error; ``lead_in`` before it gives the solver statuses of set-up's lead-in
ticks, which start from the controller's cold carry and lie outside the
window. Without as many CUDA devices
as the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    # every build and kernel cache stays inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from mpcbench.core import spec

    chips = spec.workload(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mpcbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from mpcbench.core import driver

    result = driver.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), device="cuda", t_start=T_START)
    loaded = driver.forbidden_modules()
    if loaded:
        print(f"mpcbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(f"lead_in {json.dumps(result['lead_in'])}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
