"""The port's condense modes against its own sequential chain and against
the JAX package's same mode.

``condense_mode`` only changes how the chain (F_k, f_k) is built:
"assoc" (a log-depth scan over the per-knot affine maps), "structured"
(momentum and jet sub-chains plus prefix sums) and "paired" (two steps a
product) must give the sequential chain's F, f, H_c and q_c to float32
tolerance. Inputs: the hover states of tests/test_condensed.py with the
modes it holds on them (assoc on seed 5, structured and paired on seed 11)
at its tolerances, and every mode on the first recorded flight tick, where
the error of f is taken relative to f's largest entry (JAX's own assoc
chain differs from its sequential chain there by 8.2e-5 in f, absolute,
printed by ``test_mode_matches_port_sequential_and_jax -s``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ironcub_mpc_tpu.core.config import MPCConfig as JMPCConfig
from ironcub_mpc_tpu.core.config import RobotConfig, joint_selector
from ironcub_mpc_tpu.horizon import build_schedule as jbuild_schedule
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.ops import jet_model as jjm
from ironcub_mpc_tpu.qp import condensed as jcond
from ironcub_mpc_tpu.qp import mpc as jmpc
from ironcub_mpc_tpu.runtime.replay import load_flight_replay as jload

from ironcub_mpc_tpu_torch import convert
from ironcub_mpc_tpu_torch.horizon.schedule import build_schedule
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.qp import condensed as tcond
from ironcub_mpc_tpu_torch.qp import mpc as tmpc
from ironcub_mpc_tpu_torch.qp.blocks import LinearizedDynamics

from helpers import make_hover_snapshot, make_test_trajectories
from test_torch_tick import _np, _port_cfg, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
MODES = ("assoc", "structured", "paired")
SETTINGS = jadmm.ADMMSettings(max_iter=200)


def _prep(source):
    """(JAX config, schedule, tick prep, problem, the carry after the prep,
    joint-regularisation and initial-throttle gradients) of one tick."""
    if source == "recorded":
        jr = jload()
        cfg, sched, sel = jr.cfg, jr.sched, jr.sel
        problem, carry = jr.configure(SETTINGS)
        snap, est = jr.snap_of(1), jr.est_td[0]
    else:
        seed, e = {"hover5": (5, 0.0), "hover11": (11, 0.3)}[source]
        cfg = JMPCConfig()
        sched = jbuild_schedule(cfg)
        sel = joint_selector(RobotConfig(), cfg)
        snap = make_hover_snapshot(rng_seed=seed)
        channels, alpha = make_test_trajectories()
        problem, carry = jmpc.configure(cfg, sched, sel, snap, channels,
                                        alpha, SETTINGS)
        est = jnp.full(4, e)
    carry2, prep = jmpc._tick_prep(cfg, sel, problem, carry, snap, est)
    selA = jnp.asarray(sel)
    jrg = cfg.weight_regularization_joint_pos * (
        carry2.joints_pos_ref[selA] - problem.joint_pos_ref_ctrl)
    tig = -cfg.weight_initial_throttle * jjm.throttle_to_v(carry2.throttle_cmd)
    return cfg, sched, prep, problem, carry2, jrg, tig


def _t(a):
    return torch.as_tensor(np.array(a))[None]


def _port_condense(cfg, prep, problem, carry2, jrg, tig, batch_jitter=None):
    """The port's condense on the JAX tick's inputs; with ``batch_jitter``
    [B, 26] the initial state differs per lane."""
    tcfg = _port_cfg(cfg)
    lin = LinearizedDynamics(*(_t(a) for a in prep.lin))
    x0 = _t(prep.x0)
    args = [x0, _t(prep.state_ref), _t(jrg), _t(tig), _t(prep.pin),
            _t(carry2.throttle_cmd)]
    if batch_jitter is not None:
        B = batch_jitter.shape[0]
        lin = LinearizedDynamics(*(a.expand(B, *a.shape[1:]) for a in lin))
        args = [a.expand(B, *a.shape[1:]) for a in args]
        args[0] = args[0] + torch.as_tensor(batch_jitter)
    x0, ref, jr_, ti, pin, thr = args
    return tcond.condense(
        tcfg, build_schedule(tcfg), lin, x0, ref,
        torch.as_tensor(np.asarray(jnp.diagonal(problem.Q))),
        torch.as_tensor(np.asarray(problem.H_u)), jr_, ti, pin, thr)


@functools.lru_cache(maxsize=None)
def _qps(source):
    """Every mode's condensed QP on one tick of ``source``, on both
    sides."""
    cfg, sched, prep, problem, carry2, jrg, tig = _prep(source)
    out = {}
    for mode in ("sequential",) + MODES:
        mcfg = dataclasses.replace(cfg, condense_mode=mode)
        jq = jcond.condense(mcfg, sched, prep.lin, prep.x0, prep.state_ref,
                            jnp.diagonal(problem.Q), problem.H_u, jrg, tig,
                            prep.pin, carry2.throttle_cmd)
        out[mode] = (_np(jq), _port_condense(mcfg, prep, problem, carry2,
                                             jrg, tig))
    return out


def _assert_same_qp(got, want, source, what):
    """test_condensed.py's tolerances: F, f 5e-5 (relative to f's largest
    entry on the recorded tick), H_c and q_c 2e-5 of their largest entry,
    the bounds exact."""
    f_scale = max(np.abs(want.f).max(), 1.0) if source == "recorded" else 1.0
    for name, atol in (("F", 5e-5), ("f", 5e-5 * f_scale),
                       ("H", 2e-5 * np.abs(want.H).max()),
                       ("q", 2e-5 * np.abs(want.q).max())):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=atol,
                                   err_msg=f"{what}: {name}")
    for name in ("lb", "ub"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{what}: {name}")


def _lane0(tq):
    return tcond.CondensedQP(*(a[0].numpy() for a in tq))


# the hover states and modes of tests/test_condensed.py (assoc on seed 5,
# structured and paired on seed 11), and every mode on the recorded tick
CASES = [("hover5", "assoc"), ("hover11", "structured"),
         ("hover11", "paired")] + [("recorded", m) for m in MODES]


@pytest.mark.parametrize("source,mode", CASES)
def test_mode_matches_port_sequential_and_jax(source, mode):
    out = _qps(source)
    jq, tq = out[mode]
    jseq, tseq = out["sequential"]
    print(f"\n{source}, {mode} against sequential, max |Δf|: JAX "
          f"{np.abs(jq.f - jseq.f).max():.3e}, port "
          f"{(tq.f - tseq.f).abs().max():.3e}")
    _assert_same_qp(_lane0(tq), _lane0(tseq), source,
                    f"{mode} against the port's sequential chain")
    _assert_same_qp(_lane0(tq), jq, source, f"{mode} against JAX's {mode}")


@pytest.mark.parametrize("mode", ("sequential",) + MODES)
def test_mode_lanes_condense_as_alone(mode):
    """Three lanes with distinct initial states: each lane of the batched
    chain equals the same lane condensed alone."""
    cfg, _, prep, problem, carry2, jrg, tig = _prep("hover11")
    cfg = dataclasses.replace(cfg, condense_mode=mode)
    jitter = (0.05 * np.random.default_rng(1).standard_normal((3, 26))
              ).astype(np.float32)
    batch = _port_condense(cfg, prep, problem, carry2, jrg, tig, jitter)
    for b in range(3):
        alone = _port_condense(cfg, prep._replace(x0=np.asarray(prep.x0)
                                                  + jitter[b]),
                               problem, carry2, jrg, tig)
        for name in tcond.CondensedQP._fields:
            want = getattr(alone, name)[0].numpy()
            np.testing.assert_allclose(
                getattr(batch, name)[b].numpy(), want, rtol=0,
                atol=1e-6 * max(np.abs(want).max(), 1.0),
                err_msg=f"lane {b} {name}")


@pytest.mark.parametrize("mode", MODES)
def test_mode_full_mpc_tick_matches_sequential(mode):
    """Three whole ticks under each mode give the sequential mode's commands
    to solver-noise tolerance (the mirror of tests/test_condensed.py::
    test_structured_condensing_full_mpc_tick, whose tolerances these are)."""
    snap = convert.snapshot_from_numpy(_np(make_hover_snapshot(rng_seed=3)),
                                       CPU)
    channels, alpha = make_test_trajectories()
    settings = tadmm.ADMMSettings(max_iter=200)
    outs = {}
    for m in (mode, "sequential"):
        cfg = dataclasses.replace(_port_cfg(JMPCConfig()), condense_mode=m)
        sched = build_schedule(cfg)
        sel = joint_selector(RobotConfig(), cfg)
        problem, carry = tmpc.configure(cfg, sched, sel, snap, channels,
                                        alpha, settings, device="cpu")
        for _ in range(3):
            carry, out = tmpc.mpc_tick(cfg, sched, sel, settings, problem,
                                       carry, snap, torch.zeros((1, 4)))
        outs[m] = out
    a, b = outs[mode], outs["sequential"]
    assert int(a.status[0]) in (1, 2) and int(b.status[0]) in (1, 2)
    for name, atol in (("joints_pos_ref", 1e-4), ("throttle", 1e-2),
                       ("thrust_des", 1e-2)):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=0,
                                   atol=atol, err_msg=name)


def test_structured_without_jet_dynamics_is_sequential():
    """Without the jet chain "structured" falls back to the sequential
    chain, as in the JAX package; an unknown mode is refused."""
    cfg, _, prep, problem, carry2, jrg, tig = _prep("hover5")
    cfg = dataclasses.replace(cfg, use_jet_dynamic=False)
    seq = _port_condense(dataclasses.replace(cfg, condense_mode="sequential"),
                         prep, problem, carry2, jrg, tig)
    st = _port_condense(dataclasses.replace(cfg, condense_mode="structured"),
                        prep, problem, carry2, jrg, tig)
    for name in tcond.CondensedQP._fields:
        assert torch.equal(getattr(st, name), getattr(seq, name)), name
    with pytest.raises(ValueError, match="condense_mode"):
        _port_condense(dataclasses.replace(cfg, condense_mode="blocked"),
                       prep, problem, carry2, jrg, tig)
