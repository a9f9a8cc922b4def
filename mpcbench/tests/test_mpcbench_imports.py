"""What the benchmark may load: nothing that `mpcbench/run.py` runs imports
`jax`, `jaxlib`, `flax` or the JAX package `ironcub_mpc_tpu` (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program either, and of the harness only
`core/port.py` and the loops (`loops/*.py`) import the program, inside
functions."""

import ast
import subprocess
import sys

from mpcbench.core import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "ironcub_mpc_tpu"}

# import hooks that refuse the forbidden names, then a tiny CPU run of a
# cell (every lazy import of the run happens) or of the reference
BLOCK = """
import sys
sys.path.insert(0, {root!r})
BLOCKED = set({blocked!r})
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""
RUN = """
from mpcbench.core import driver
res = driver.run({cell!r}, 7, 0.5, {trace}, device="cpu", overrides=dict(
    lanes=2, check_lanes=1, warm_passes=0, trace_ticks=1))
print(sorted({{m.split(".")[0] for m in sys.modules}} & BLOCKED))
"""
REF = """
from mpcbench.reference import chain
import numpy as np
out = chain.run_lane({config!r}, {stream!r}, np.zeros(6), 0, None, 2)
assert out["throttle"].shape == (2, 4)
print(sorted({{m.split(".")[0] for m in sys.modules}} & BLOCKED))
"""


def python(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    cell = spec.benchmark()["workloads"][0]["name"]
    for trace in (False, True):
        code = (BLOCK.format(root=str(ROOT), blocked=sorted(FORBIDDEN))
                + RUN.format(cell=cell, trace=trace))
        assert python(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    blocked = sorted(FORBIDDEN | {"ironcub_mpc_tpu_torch", "torch"})
    bench = spec.benchmark()
    code = (BLOCK.format(root=str(ROOT), blocked=blocked)
            + REF.format(config=str(spec.config_path(
                bench, bench["configs"][0]["name"])),
                stream=str(spec.stream_path("takeoff"))))
    assert python(code) == "[]"


def imports(tree):
    """The import statements of ``tree``."""
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))]


def module_level(tree):
    """The import statements of ``tree`` that run when the module is
    imported: those outside every function's body."""
    inner = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in imports(f)}
    return [n for n in imports(tree) if id(n) not in inner]


def imported_names(path, select=imports):
    names = set()
    for node in select(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    bench_dir = ROOT / "mpcbench"
    for path in bench_dir.rglob("*.py"):
        names = imported_names(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if "reference" in path.parts:
            assert "ironcub_mpc_tpu_torch" not in names, path
            assert "mpcbench" not in names, path


def test_only_port_and_loops_import_the_program():
    bench_dir = ROOT / "mpcbench"
    harness = [p for p in bench_dir.rglob("*.py")
               if "tests" not in p.relative_to(bench_dir).parts]
    allowed = {bench_dir / "core" / "port.py",
               *(bench_dir / "loops").glob("*.py")}
    assert bench_dir / "loops" / "replay.py" in allowed
    for path in harness:
        names = imported_names(path, module_level)
        assert "ironcub_mpc_tpu_torch" not in names, path
        if path not in allowed:
            assert "ironcub_mpc_tpu_torch" not in imported_names(path), path
