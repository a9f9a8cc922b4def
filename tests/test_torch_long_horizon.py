"""The port at the shapes past the kernels' stock layout, against the JAX
package: a control horizon of 13 with joint limits on the recorded stream,
the refresh at P = 384 and P = 640, the grouped segment at group 16 and at
P = 256.

``MPCConfig(control_horizon=13, use_joint_position_constraint=True)`` has
nU = 8·13 + 4·7 = 132 inputs, all boxed: P = 256 with n_box 132 at box0 0,
which the refresh's tuned routes on the card do not take (their box is at
most 128); ``woodbury_plan`` sends it to the general route. On the CPU the
wrappers run their twins, which are held here against the Pallas kernels in
interpret mode, as tests/test_torch_kernels.py does at the stock shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.horizon import schedule as jschedule
from ironcub_mpc_tpu.ops import admm as jadmm
from ironcub_mpc_tpu.ops import pallas_solve
from ironcub_mpc_tpu.qp import condensed as jcond
from ironcub_mpc_tpu.runtime.replay import load_flight_replay as jload

from ironcub_mpc_tpu_torch.horizon import schedule as tschedule
from ironcub_mpc_tpu_torch.ops import admm as tadmm
from ironcub_mpc_tpu_torch.ops import kernels
from ironcub_mpc_tpu_torch.qp import condensed as tcond
from ironcub_mpc_tpu_torch.runtime.replay import load_flight_replay as tload

from test_torch_kernels_gpu import (ALPHA, SIGMA, _segment_inputs,
                                    _woodbury_inputs)
from test_torch_tick import BENCH, _check_tick, _run_both

LONG_HORIZON = dict(control_horizon=13, use_joint_position_constraint=True)


@pytest.fixture(scope="module")
def long_horizon():
    """The recorded stream configured at LONG_HORIZON on both sides. The
    stream carries snapshots, not a horizon: ``configure`` cuts the
    reference windows to the new one, as it does for the joint-limits
    configuration of tests/test_torch_tick.py."""
    jr, tr = jload(), tload(device="cpu")
    jcfg = dataclasses.replace(jr.cfg, **LONG_HORIZON)
    tcfg = dataclasses.replace(tr.cfg, **LONG_HORIZON)
    jr = jr._replace(cfg=jcfg, sched=jschedule.build_schedule(jcfg))
    tr = tr._replace(cfg=tcfg, sched=tschedule.build_schedule(tcfg))
    problem, carry = jr.configure(jadmm.ADMMSettings(**BENCH))
    return jr, tr, problem, carry


def test_long_horizon_sizes(long_horizon):
    _, tr, _, _ = long_horizon
    nu, nb = tcond.n_inputs(tr.cfg), tcond.n_box(tr.cfg)
    assert (nu, nb) == (132, 132)
    assert (nu, nb) == (jcond.n_inputs(long_horizon[0].cfg),
                        jcond.n_box(long_horizon[0].cfg))
    p = kernels._pad_to(nu)
    assert p == 256
    assert kernels.woodbury_plan(1, p, nb, 1)["route"] == "general"
    assert kernels.segment_plan(1, p)["variant"] == "streamed"


def test_tick_long_horizon_joint_limits_matches_jax(long_horizon):
    """Two replay ticks at batch 1: the kernels' layout (their twins here)
    against the Pallas kernels, at the tolerances of
    test_torch_tick::test_tick_joint_limits_matches_jax except two, for a
    reason of the reference itself: at this horizon JAX's own Pallas and
    pure-JAX ticks differ by 2.7e-5 of final_state's largest entry on tick
    0 and by 3.6e-4 % throttle from tick 1 (measured over these ticks), and
    the port follows the Pallas tick to 3.4e-5 and 9.6e-4 %. final_state is
    held to 5e-5 (2e-5 at the stock horizon) and throttle to 2e-3 % (1e-3);
    joints, thrust_des, status, guard_fired and the counters stay as
    tight."""
    js = jadmm.ADMMSettings(**BENCH, pallas_mode="on")
    ts = tadmm.ADMMSettings(**BENCH, kernel_mode="on")
    tol = dict(joints=1e-4, throttle=2e-3, thrust_des=1e-3,
               final_state=5e-5)
    before = (kernels.admm_segment.launches, kernels.woodbury_ns.launches)
    n = 0
    for t, jo, jc, to, tc in _run_both(long_horizon, js, ts, 1, 2):
        _check_tick(t, jo, jc, to, tc, 1, tol)
        assert to.final_state.shape == (1, 26)
        n += 1
    assert n == 2
    assert before == (kernels.admm_segment.launches,
                      kernels.woodbury_ns.launches)   # the twins ran


@pytest.mark.parametrize("n_box", [8, 80])
@pytest.mark.parametrize("p,nu", [(384, 288), (640, 528)])
def test_woodbury_ns_twin_matches_pallas_at_larger_padded_sizes(p, nu, n_box):
    """The refresh with one Newton–Schulz step at P = 384 (nU = 288) and
    P = 640 (nU = 528), the box at the end of the inputs as the throttle
    knots are; the tolerance of
    test_torch_kernels::test_woodbury_ns_twin_matches_pallas."""
    box0 = nu - n_box
    H, rho_new, ins = _woodbury_inputs(20 + n_box, 2, nu, box0, p=p)
    one = lambda k, h, d, r: pallas_solve.woodbury_ns(  # noqa: E731
        k, h, d[:, None], r[:, None], box0=box0, n_box=n_box, sigma=SIGMA,
        n_ns=1)
    ref = np.asarray(jax.jit(jax.vmap(one))(
        *(jnp.asarray(v) for v in ins.values())))
    got = kernels.woodbury_ns(*(torch.as_tensor(v) for v in ins.values()),
                              box0=box0, n_box=n_box, sigma=SIGMA,
                              n_ns=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    assert np.all(got[:, nu:, :] == 0) and np.all(got[:, :, nu:] == 0)
    K = H + SIGMA * np.eye(nu) + np.pad(rho_new, ((0, 0), (box0, 0)))[
        :, None, :] * np.eye(nu)
    assert np.abs(got[:, :nu, :nu] @ K - np.eye(nu)).max() < 1e-3


@pytest.mark.parametrize("batch,group,p,nu,box0", [(32, 16, 128, 120, 96),
                                                   (16, 8, 256, 240, 192)],
                         ids=["group16", "p256"])
def test_admm_segment_grouped_twin_matches_pallas(batch, group, p, nu, box0):
    """A group of 16 (refused on the card before the grouped kernel's
    redesign) and P = 256, against the Pallas grouped kernel in interpret
    mode; the tolerance of test_torch_kernels's grouped test."""
    ins = _segment_inputs(17, batch, nu=nu, box0=box0, p=p)
    kw = dict(sigma=SIGMA, alpha=ALPHA, length=6)
    ref = pallas_solve.admm_segment_grouped(
        *(jnp.asarray(v) for v in ins.values()), group=group, **kw)
    got = kernels.admm_segment_grouped(
        *(torch.as_tensor(v) for v in ins.values()), group=group, **kw)
    for g, r in zip(got, ref):
        assert g.shape == (batch, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)
