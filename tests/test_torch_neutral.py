"""The PyTorch port's framework-neutral layer against the JAX package.

The port keeps its own copies of the numpy-only modules (configuration,
state layout, horizon schedule, constant Hessians) so that it never imports
JAX. These tests hold each copy equal to its source, field for field, and
check in a subprocess with JAX blocked that no module of the port imports
it.
"""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ironcub_mpc_tpu.core import config as jconfig
from ironcub_mpc_tpu.core import constants as jconst
from ironcub_mpc_tpu.horizon import schedule as jschedule
from ironcub_mpc_tpu.qp import assembly as jassembly
from ironcub_mpc_tpu.qp import condensed as jcondensed

import ironcub_mpc_tpu_torch
from ironcub_mpc_tpu_torch.core import config as tconfig
from ironcub_mpc_tpu_torch.core import constants as tconst
from ironcub_mpc_tpu_torch.horizon import schedule as tschedule
from ironcub_mpc_tpu_torch.qp import assembly as tassembly
from ironcub_mpc_tpu_torch.qp import condensed as tcondensed

ROOT = Path(__file__).resolve().parents[1]

# the stock horizon and a non-default one (shapes and warp must adapt)
HORIZONS = [{}, dict(n_iter=9, n_iter_small=4, control_horizon=6),
            dict(use_joint_position_constraint=True)]


def _same(a, b, what):
    if isinstance(a, float) or isinstance(b, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), what
    elif isinstance(a, (tuple, list, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    else:
        assert a == b, what


def _fields_equal(a, b):
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)]
    for name in fa:
        _same(getattr(a, name), getattr(b, name), name)


@pytest.mark.parametrize("cls", ["MPCConfig", "RobotConfig", "SimConfig"])
def test_config_defaults_match(cls):
    _fields_equal(getattr(tconfig, cls)(), getattr(jconfig, cls)())


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        _same(getattr(tconst, n), getattr(jconst, n), n)


@pytest.mark.parametrize("over", HORIZONS, ids=["stock", "short", "jointlim"])
def test_schedule_and_constant_hessians_match(over):
    jcfg = dataclasses.replace(jconfig.MPCConfig(), **over)
    tcfg = dataclasses.replace(tconfig.MPCConfig(), **over)
    js, ts = jschedule.build_schedule(jcfg), tschedule.build_schedule(tcfg)
    _fields_equal(ts, js)
    assert tconfig.joint_selector(tconfig.RobotConfig(), tcfg) == \
        jconfig.joint_selector(jconfig.RobotConfig(), jcfg)
    np.testing.assert_array_equal(tcondensed.build_hu(tcfg),
                                  jcondensed.build_hu(jcfg))
    np.testing.assert_array_equal(tassembly.build_hessian(tcfg),
                                  jassembly.build_hessian(jcfg))
    np.testing.assert_array_equal(tassembly.state_weight_matrix(tcfg),
                                  jassembly.state_weight_matrix(jcfg))
    assert tcondensed.n_inputs(tcfg) == jcondensed.n_inputs(jcfg)
    assert tcondensed.n_box(tcfg) == jcondensed.n_box(jcfg)
    assert tcondensed.weighted_state_indices(tcfg) == \
        jcondensed.weighted_state_indices(jcfg)


def _port_modules():
    names = ["ironcub_mpc_tpu_torch"]
    for info in pkgutil.walk_packages(ironcub_mpc_tpu_torch.__path__,
                                      "ironcub_mpc_tpu_torch."):
        names.append(info.name)
    return names


def test_port_never_imports_jax():
    """Every module of the port, chip_smoke.py, bench_torch.py, the port's
    tools and examples and the card-only test files import with JAX and the
    JAX package blocked."""
    mods = _port_modules()
    for m in ("ops.kernels", "dynamics.kinodynamics", "dynamics.wrenches",
              "dynamics.model", "dynamics.urdf", "dynamics.urdf_export",
              "dynamics.ironcub_model", "runtime.trajectory", "runtime.loop",
              "runtime.flight", "runtime.checkpoint", "sim.jet_lstm",
              "sim.ekf", "sim.plant", "convert", "parallel", "parallel.mesh",
              "parallel.monte_carlo", "parallel.tp_admm",
              "parallel.pp_pipeline", "parallel.dryrun", "ops.admm",
              "qp.assembly", "qp.mpc", "qp.condensed", "utils",
              "utils.profiling", "runtime.native", "runtime.telemetry",
              "sim.mjcf", "sim.mujoco_sim", "sim.validate"):
        assert f"ironcub_mpc_tpu_torch.{m}" in mods
    code = (
        "import sys, importlib, runpy\n"
        "for m in ('jax', 'jaxlib', 'ironcub_mpc_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "runpy.run_path('bench_torch.py', run_name='not_main')\n"
        "for tool in ('bench_segment_kernels_torch', "
        "'run_robustness_sweep_torch', 'run_mismatch_sweep_torch', "
        "'capture_rt_torch', 'compare_plants_torch', 'common_torch', "
        "'fly_full_trajectory_torch', 'profile_tick_torch', "
        "'profile_chained_stages_torch', 'profile_condense_torch', "
        "'profile_solve_parts_torch', 'bench_ns_skip_torch', "
        "'bench_joint_limits_latency_torch', 'debug_qp_torch', "
        "'record_flight_snapshots_torch', 'make_calibrated_urdf_torch', "
        "'bench_woodbury_general_torch', 'bench_segment_streamed_torch'):\n"
        "    runpy.run_path(f'tools/{tool}.py', run_name='not_main')\n"
        "sys.path.insert(0, 'tests')\n"
        "runpy.run_path('tests/oracle_replay.py', run_name='not_main')\n"
        "for demo in ('realtime_driver', 'hover_demo', 'closed_loop_demo', "
        "'flight_demo'):\n"
        "    runpy.run_path(f'examples/{demo}_torch.py', run_name='not_main')\n"
        "for card_test in ('kernels', 'flight', 'full', 'parallel'):\n"
        "    runpy.run_path(f'tests/test_torch_{card_test}_gpu.py', "
        "run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ironcub_mpc_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("opts", [
    {}, dict(floor=True, actuators=True),
    dict(floor=True, actuators=True, kp=900.0, kd=45.0, timestep=0.002)],
    ids=["bare", "plant", "tuned"])
def test_mjcf_copy_matches(opts):
    """``sim/mjcf.py`` is a copy: the same XML as the source's for the
    generated model under each option."""
    from ironcub_mpc_tpu.dynamics import build_ironcub_model as jbuild
    from ironcub_mpc_tpu.sim import mjcf as jmjcf
    from ironcub_mpc_tpu_torch.dynamics import build_ironcub_model as tbuild
    from ironcub_mpc_tpu_torch.sim import mjcf as tmjcf

    assert tmjcf.mjcf_from_model(tbuild(), **opts) == \
        jmjcf.mjcf_from_model(jbuild(), **opts)


def test_import_pins_ieee_fp32():
    import torch

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_refuse_silent_cpu_fallback():
    """With no card and no explicit device, an entry point raises instead of
    moving to the CPU on its own."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_flight_replay()
    assert ironcub_mpc_tpu_torch.resolve_device("cpu").type == "cpu"


def test_admm_settings_match_except_the_two_renamed_fields():
    """Every field and default of the JAX package's ADMMSettings, with
    pallas_mode -> kernel_mode and guard_axis -> batch_guard, and the same
    __post_init__ checks."""
    from ironcub_mpc_tpu.ops import admm as jadmm
    from ironcub_mpc_tpu_torch.ops import admm as tadmm

    renamed = {"pallas_mode": "kernel_mode", "guard_axis": "batch_guard"}
    jf = [renamed.get(f.name, f.name)
          for f in dataclasses.fields(jadmm.ADMMSettings)]
    tf = [f.name for f in dataclasses.fields(tadmm.ADMMSettings)]
    assert sorted(jf) == sorted(tf)
    j, t = jadmm.ADMMSettings(), tadmm.ADMMSettings()
    for f in dataclasses.fields(j):
        if f.name not in renamed:
            _same(getattr(t, f.name), getattr(j, f.name), f.name)
    assert t.kernel_mode == j.pallas_mode == "auto"
    assert t.batch_guard is False and j.guard_axis is None
    for bad in (dict(ns_steps=0), dict(polish_ns_steps=-1),
                dict(ns_skip_tol=0.1), dict(term_check_every=-1)):
        with pytest.raises(ValueError):
            jadmm.ADMMSettings(**bad)
        with pytest.raises(ValueError):
            tadmm.ADMMSettings(**bad)
    with pytest.raises(ValueError):
        tadmm.ADMMSettings(kernel_mode="fast")
    assert [jadmm.UNSOLVED, jadmm.SOLVED, jadmm.SOLVED_INACCURATE,
            jadmm.PRIMAL_INFEASIBLE, jadmm.DUAL_INFEASIBLE,
            jadmm.MAX_ITER_REACHED] == [
        tadmm.UNSOLVED, tadmm.SOLVED, tadmm.SOLVED_INACCURATE,
        tadmm.PRIMAL_INFEASIBLE, tadmm.DUAL_INFEASIBLE,
        tadmm.MAX_ITER_REACHED]
