"""The port's four-stage pipelined tick (``parallel/pp_pipeline.py``) against
the JAX package's vmapped tick and against the port's own monolithic tick.

The inputs are those of ``tests/test_pp_pipeline.py``: the hover state of
``__graft_entry__._setup``, batch 8 (4 in debug-log mode), ``max_iter=40``
and one ρ mark at 15, JAX ``pallas_mode="off"`` against the port's
``kernel_mode="off"``, per-lane decisions on both sides; the lane jitter on
the momentum and ``est_thrust_dot`` are drawn with numpy (JAX's test draws
them from its PRNG keys) and given to both.

Tolerances: against JAX, those of ``tests/test_torch_tick.py``'s batched
tick (joints 1e-4, throttle 0.1 %, thrust_des 1e-3, final_state 1e-2 of its
largest entry, for the reason written there: JAX's own vmapped tick parts
from its unbatched one at float32 rounding), the carried warm start at
final_state's, the counters and statuses equal; against the port's
monolithic tick, JAX's own 1e-5 between its pipelined and vmapped ticks.
On the CPU the stages run in turn; ``tests/test_torch_parallel_gpu.py``
holds the four streams of one card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from ironcub_mpc_tpu.core.config import MPCConfig as JMPCConfig
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.qp import mpc as jmpc

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.core.types import expand_lanes
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.parallel import N_STAGES, pipeline_tick
from ironcub_mpc_tpu_torch.qp import mpc as tmpc
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay

from test_torch_tick import _np, _port_cfg, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
# tests/test_torch_tick.py's batched tolerances against JAX
TOL_JAX = dict(joints_pos_ref=1e-4, throttle=0.1, thrust_des=1e-3,
               final_state=1e-2)
# tests/test_pp_pipeline.py's tolerance, pipelined against monolithic
TOL_SELF = 1e-5
COUNTERS = ("throttle_counter", "pos_traj_idx", "ref_counter",
            "alpha_traj_idx", "n_turns")


def _normalised(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).reshape(a.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _both(cfg, settings, batch, seed=0):
    """JAX's setup and batched inputs, and the same on the port's side."""
    jcfg, sched, sel, js, problem, carry, snap, _ = ge._setup(
        cfg=cfg, settings=settings)
    rng = np.random.default_rng(seed)
    jitter = (0.2 * rng.standard_normal((batch, 6))).astype(np.float32)
    est = (0.5 * rng.standard_normal((batch, 4))).astype(np.float32)
    carries = jax.tree.map(lambda a: jnp.stack([a] * batch), carry)
    snaps = jax.tree.map(lambda a: jnp.stack([a] * batch), snap)
    snaps = snaps._replace(momentum_body=snaps.momentum_body + jitter)
    ref_c, ref_o = jax.jit(jax.vmap(
        lambda c, s, e: jmpc.mpc_tick(jcfg, sched, sel, js, problem, c, s,
                                      e)))(carries, snaps, jnp.asarray(est))
    tcfg = _port_cfg(jcfg)
    port = dict(cfg=tcfg, sched=build_schedule(tcfg), sel=tuple(sel),
                problem=convert.problem_from_numpy(_np(problem), CPU),
                carries=expand_lanes(convert.carry_from_numpy(
                    _np(carry), CPU), batch),
                snaps=convert.snapshot_from_numpy(_np(snaps), CPU,
                                                  batched=True),
                est=torch.as_tensor(est))
    return _np(ref_c), _np(ref_o), port


def _port_ticks(port, settings):
    args = (port["cfg"], port["sched"], port["sel"], settings,
            port["problem"], port["carries"], port["snaps"], port["est"])
    return pipeline_tick(*args), tmpc.mpc_tick(*args)


def test_pipeline_matches_vmapped_tick():
    js = jadmm.ADMMSettings(max_iter=40, rho_update_iters=(15,),
                            pallas_mode="off")
    ts = tadmm.ADMMSettings(max_iter=40, rho_update_iters=(15,),
                            kernel_mode="off")
    ref_c, ref_o, port = _both(None, js, 8)
    (pp_c, pp_o), (mo_c, mo_o) = _port_ticks(port, ts)

    np.testing.assert_array_equal(pp_o.status.numpy(), ref_o.status)
    np.testing.assert_array_equal(pp_o.status.numpy(), mo_o.status.numpy())
    for field, tol in TOL_JAX.items():
        got = getattr(pp_o, field).numpy()
        err = _normalised(got, getattr(ref_o, field))
        assert err < tol, f"{field} against JAX: {err:.3e}"
        err = _normalised(got, getattr(mo_o, field).numpy())
        assert err < TOL_SELF, f"{field} against monolithic: {err:.3e}"
    # carries agree too (warm starts, integrated commands, counters)
    for field, tol in (("joints_pos_ref", TOL_JAX["joints_pos_ref"]),
                       ("throttle_cmd", TOL_JAX["throttle"]),
                       ("warm_x", TOL_JAX["final_state"])):
        got = getattr(pp_c, field).numpy()
        err = _normalised(got, getattr(ref_c, field))
        assert err < tol, f"carry {field} against JAX: {err:.3e}"
    for field in pp_c._fields:
        got, mono = getattr(pp_c, field), getattr(mo_c, field)
        assert got.shape == mono.shape, field
        err = _normalised(got.numpy(), mono.numpy())
        assert err < TOL_SELF, f"carry {field} against monolithic: {err:.3e}"
    for field in COUNTERS:
        np.testing.assert_array_equal(
            getattr(pp_c, field).numpy(),
            np.asarray(getattr(ref_c, field)).reshape(
                getattr(pp_c, field).shape), err_msg=field)


def test_pipeline_emits_debug_info():
    """enable_debug_log_mode flows through the pipelined tick like the
    monolithic one (the full F/f ride the ring; the same DebugInfo)."""
    js = jadmm.ADMMSettings(max_iter=30, rho_update_iters=(12,),
                            pallas_mode="off")
    ts = tadmm.ADMMSettings(max_iter=30, rho_update_iters=(12,),
                            kernel_mode="off")
    cfg = dataclasses.replace(JMPCConfig(), enable_debug_log_mode=True)
    _, ref_o, port = _both(cfg, js, 4)
    (_, pp_o), (_, mo_o) = _port_ticks(port, ts)
    assert pp_o.debug is not None
    # the tolerances tests/test_torch_debug.py holds the port's DebugInfo
    # to JAX's at: block costs 1e-4 relative (tests/test_pp_pipeline.py's
    # own between JAX's pipelined and vmapped ticks), the bounds 1e-5 of
    # their largest entry (JAX's pipeline holds its own to 1e-6 absolute;
    # the port's bounds, up to ~10, part from JAX's at float32 rounding)
    np.testing.assert_allclose(pp_o.debug.block_costs.numpy(),
                               ref_o.debug.block_costs, rtol=1e-4)
    err = _normalised(pp_o.debug.constraint_ub.numpy(),
                      ref_o.debug.constraint_ub)
    assert err < 1e-5, f"debug constraint_ub against JAX: {err:.3e}"
    for field in pp_o.debug._fields:
        err = _normalised(getattr(pp_o.debug, field).numpy(),
                          getattr(mo_o.debug, field).numpy())
        assert err < TOL_SELF, f"debug {field} against monolithic: {err:.3e}"


def test_pipeline_chains_on_the_kernel_layout():
    """Three chained ticks of the recorded stream at batch 8 on the
    kernels' padded layout (the plain twins on the CPU): the K⁻¹ and ρ
    that S2 folds into the carry are the next tick's, lane for lane as the
    monolithic tick's."""
    replay = load_flight_replay(device="cpu")
    settings = tadmm.ADMMSettings(max_iter=40, polish=True,
                                  rho_update_iters=(15,), kinv_guard=True,
                                  ns_skip_tol=0.02, term_check_every=5,
                                  kernel_mode="on")
    problem, carry = replay.configure(settings)
    jitter = torch.as_tensor((0.1 * np.random.default_rng(1).standard_normal(
        (8, 6))).astype(np.float32))
    pc = mc = expand_lanes(carry, 8)
    for t in range(3):
        snap, est = replay.tick_inputs(t, 8, jitter)
        args = (replay.cfg, replay.sched, replay.sel, settings, problem)
        pc, po = pipeline_tick(*args, pc, snap, est)
        mc, mo = tmpc.mpc_tick(*args, mc, snap, est)
        np.testing.assert_array_equal(po.status.numpy(), mo.status.numpy())
        # the cold first tick closes SOLVED_INACCURATE, the later ones solve
        want = tadmm.SOLVED_INACCURATE if t == 0 else tadmm.SOLVED
        assert bool((po.status == want).all()), (t, po.status)
        for field in ("joints_pos_ref", "throttle", "thrust_des",
                      "final_state"):
            err = _normalised(getattr(po, field).numpy(),
                              getattr(mo, field).numpy())
            assert err < TOL_SELF, f"tick {t} {field}: {err:.3e}"
        for field in ("kinv", "rho_vec", "rho_scalar", "warm_x", "warm_y"):
            err = _normalised(getattr(pc, field).numpy(),
                              getattr(mc, field).numpy())
            assert err < TOL_SELF, f"tick {t} carry {field}: {err:.3e}"


def test_pipeline_refuses_what_it_cannot_pipeline():
    replay = load_flight_replay(device="cpu")
    settings = tadmm.ADMMSettings(batch_guard=True)
    problem, carry = replay.configure(settings)
    snap, est = replay.tick_inputs(0, N_STAGES)
    args = (replay.cfg, replay.sched, replay.sel)
    with pytest.raises(ValueError, match="per-lane"):
        pipeline_tick(*args, settings, problem,
                      expand_lanes(carry, N_STAGES), snap, est)
    per_lane = dataclasses.replace(settings, batch_guard=False)
    snap6, est6 = replay.tick_inputs(0, 6)
    with pytest.raises(ValueError, match="micro-batches"):
        pipeline_tick(*args, per_lane, problem, expand_lanes(carry, 6),
                      snap6, est6)
    with pytest.raises(ValueError, match="4 devices"):
        pipeline_tick(*args, per_lane, problem,
                      expand_lanes(carry, N_STAGES), snap, est,
                      devices=["cpu"] * 2)
