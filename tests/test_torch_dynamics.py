"""The port's kinodynamics against the JAX package.

The numpy-only model modules are copies and are held equal to their sources;
every ``KinDyn`` method, ``compute_snapshot`` and ``compute_wrench_summary``
run on the same four numpy-seeded states in both packages (the port batched
over the four lanes, the JAX package under ``jax.vmap``) and are compared
field by field. The calibrated 23-joint Mk3 model from the URDF is used, as
on the flight path.

Tolerance: rtol 1e-5 with atol 1e-6 scaled by the field's largest magnitude
(at least 1). Both sides compute in float32 but sum in different orders (the
port walks the tree with one homogeneous 4×4 product per link and contracts
links with batched matmuls), so an entry that is small by cancellation of
terms of the field's size carries a rounding error of the field's size times
float32 epsilon.

``compute_snapshot`` is also held on flown states: the golden streams
(tests/golden/flight_snapshots*.npz) carry snapshots only, so
tests/torch_fixtures/plant_states_takeoff.npz (written by
``tools/record_flight_snapshots_torch.py 3880 200 ... --plant-states
--device cpu``) carries, for 201 ticks across lift-off (t = 19.40 s to
20.40 s of the mission: the soles' normal force falls through the 5 N
ground threshold at 19.52 s and each sole's force reaches zero at 20.17
and 20.29 s), both the snapshots the port's closed loop computed and the
exact inputs it computed them from (base pose, measured base velocity,
joints, applied thrust, sole wrenches). Both packages
recompute the snapshots from those inputs, JAX under ``jax.vmap`` and the
port batched over the ticks, and each is held to the other and to the
recording at the tolerance above.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ironcub_mpc_tpu.core.config import RobotConfig
from ironcub_mpc_tpu import dynamics as jdyn
from ironcub_mpc_tpu.dynamics import urdf_export as jexport
from ironcub_mpc_tpu.dynamics import wrenches as jwrenches
from ironcub_mpc_tpu.ops import so3 as jso3

import ironcub_mpc_tpu_torch
from ironcub_mpc_tpu_torch import dynamics as tdyn
from ironcub_mpc_tpu_torch.dynamics import urdf_export as texport
from ironcub_mpc_tpu_torch.dynamics import wrenches as twrenches
from ironcub_mpc_tpu_torch.ops import so3 as tso3

from test_torch_tick import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
JETS = RobotConfig().jets_list
SOLES = ("l_sole", "r_sole")
N_STATES = 4


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the copied numpy-only modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["model", "urdf", "urdf_export",
                                  "ironcub_model"])
def test_copied_module_equals_source(name):
    """Each copy parses to the syntax tree of its source (code and
    docstrings; comments may differ) with the package name replaced."""
    src = (ROOT / "ironcub_mpc_tpu" / "dynamics" / f"{name}.py").read_text()
    dst = (ROOT / "ironcub_mpc_tpu_torch" / "dynamics" / f"{name}.py"
           ).read_text()
    want = src.replace("ironcub_mpc_tpu.dynamics",
                       "ironcub_mpc_tpu_torch.dynamics")
    assert ast.dump(ast.parse(dst)) == ast.dump(ast.parse(want))


def _models_equal(a, b):
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "frames":
            assert list(x) == list(y)
            for k in x:
                assert x[k].link == y[k].link
                np.testing.assert_array_equal(x[k].R, y[k].R)
                np.testing.assert_array_equal(x[k].p, y[k].p)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("maker", ["build_ironcub_model",
                                   "load_ironcub_model"])
def test_models_match(maker):
    _models_equal(getattr(tdyn, maker)(), getattr(jdyn, maker)())


def test_urdf_export_matches():
    m = jdyn.build_ironcub_model()
    assert texport.model_to_urdf(tdyn.build_ironcub_model(), "root_link") == \
        jexport.model_to_urdf(m, "root_link")


# ---------------------------------------------------------------------------
# so3 additions
# ---------------------------------------------------------------------------


def test_so3_rotations_match():
    rng = np.random.default_rng(3)
    rpy = rng.uniform(-1.2, 1.2, (5, 3)).astype(np.float32)
    _close(tso3.rpy_to_matrix(torch.as_tensor(rpy)).numpy(),
           jso3.rpy_to_matrix(jnp.asarray(rpy)), "rpy_to_matrix")
    for name in ("rotx", "roty", "rotz"):
        _close(getattr(tso3, name)(torch.as_tensor(rpy[:, 0])).numpy(),
               getattr(jso3, name)(jnp.asarray(rpy[:, 0])), name)
    S = tso3.skew(torch.as_tensor(rpy))
    np.testing.assert_array_equal(tso3.unskew(S).numpy(), rpy)
    np.testing.assert_array_equal(
        tso3.unskew(S).numpy(), np.asarray(jso3.unskew(jnp.asarray(S.numpy()))))


# ---------------------------------------------------------------------------
# KinDyn on four seeded states
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def states():
    """Four numpy-seeded states of the calibrated model, both KinDyns, and
    every JAX quantity computed once under one jitted vmap."""
    model = jdyn.load_ironcub_model()
    n, L = model.n_joints, model.n_links
    rng = np.random.default_rng(11)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    d = dict(
        rpy=f32(rng.uniform(-0.4, 0.4, (N_STATES, 3))),
        base_p=f32(rng.normal(0, 0.5, (N_STATES, 3)) + [0, 0, 0.8]),
        base_v=f32(rng.normal(0, 0.3, (N_STATES, 6))),
        q=f32(rng.normal(0, 0.3, (N_STATES, n))),
        qd=f32(rng.normal(0, 0.4, (N_STATES, n))),
        thrust=f32(rng.uniform(20, 200, (N_STATES, 4))),
        wrenches=f32(rng.normal(0, 50, (N_STATES, 2, 6))),
        mass_scale=f32(rng.uniform(0.9, 1.1, (N_STATES, L))),
    )
    d["wrenches"][:, :, 2] = np.abs(d["wrenches"][:, :, 2]) + 100.0
    d["wrenches"][1, :, 2] = 1.0          # lane 1 is off the ground
    d["base_R"] = f32(jso3.rpy_to_matrix(jnp.asarray(d["rpy"])))
    jkd = jdyn.KinDyn(model)
    tkd = tdyn.KinDyn(tdyn.load_ironcub_model(), device="cpu")
    gravity = f32(RobotConfig().gravity)
    jet = model.frames[JETS[0]]

    def one(base_R, base_p, base_v, q, qd, thrust, wrenches, mass_scale):
        ls = jkd.fk(base_R, base_p, q)
        J = jkd.link_spatial_jacobians(ls, base_p)
        I_sp, c_w, I_w = jkd.link_spatial_inertias(ls)
        I_sc, c_sc, I_wsc = jkd.link_spatial_inertias(
            ls, mass=jkd._mass * mass_scale,
            inertia=jkd._inertia * mass_scale[:, None, None])
        com = jkd.com(c_w)
        A_O = jkd.momentum_matrix_origin(J, I_sp)
        nu = jnp.concatenate([base_v, qd])
        p_f = ls.p[jet.link] + ls.R[jet.link] @ jnp.asarray(jet.p, jnp.float32)
        jcom = jkd.com_jacobian(J, c_w)
        ws = jwrenches.compute_wrench_summary(
            jkd, ls, J, com, SOLES, wrenches, jcom, 5.0)
        return dict(
            ls=ls, joint_subspace=jkd.joint_subspace(ls),
            base_block=jkd.base_block(base_p), J=J, I_sp=I_sp, c_w=c_w,
            I_w=I_w, I_sp_scaled=I_sc, I_w_scaled=I_wsc,
            mass_matrix=jkd.mass_matrix(J, I_sp), com=com, A_O=A_O,
            A_G=jkd.centroidal_momentum_matrix(A_O, com), jcom=jcom,
            frame_jacobian=jkd.frame_jacobian(J, ls, jet.link, p_f),
            relative_jacobian=jkd.relative_jacobian(J, ls, jet.link, p_f),
            bias=jkd.bias_forces(J, I_sp, ls, base_p, nu,
                                 jnp.asarray(gravity)),
            bias_scaled=jkd.bias_forces(J, I_sc, ls, base_p, nu,
                                        jnp.asarray(gravity)),
            wrench_summary=ws,
            snap=jdyn.compute_snapshot(jkd, JETS, base_R, base_p, base_v, q,
                                       qd, thrust),
            snap_w=jdyn.compute_snapshot(
                jkd, JETS, base_R, base_p, base_v, q, qd, thrust,
                ext_wrench_frames=SOLES, ext_wrenches_body=wrenches,
                ground_threshold=5.0))

    keys = ("base_R", "base_p", "base_v", "q", "qd", "thrust", "wrenches",
            "mass_scale")
    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(d[k]) for k in keys))
    ref = jax.tree.map(np.asarray, ref)
    t = {k: torch.as_tensor(np.array(v)) for k, v in d.items()}
    return dict(d=d, t=t, jkd=jkd, tkd=tkd, ref=ref, jet=jet,
                gravity=torch.as_tensor(gravity))


@pytest.fixture(scope="module")
def port(states):
    """The port's link states, Jacobians and inertias at the four states."""
    t, kd = states["t"], states["tkd"]
    ls = kd.fk(t["base_R"], t["base_p"], t["q"])
    J = kd.link_spatial_jacobians(ls, t["base_p"])
    I_sp, c_w, I_w = kd.link_spatial_inertias(ls)
    return dict(ls=ls, J=J, I_sp=I_sp, c_w=c_w, I_w=I_w)


def test_fk_matches(states, port):
    ref = states["ref"]["ls"]
    for name in ("R", "p", "axis_w"):
        _close(getattr(port["ls"], name).numpy(), getattr(ref, name),
               f"fk.{name}")


def test_jacobians_match(states, port):
    kd, ref, t = states["tkd"], states["ref"], states["t"]
    _close(kd.joint_subspace(port["ls"]).numpy(), ref["joint_subspace"],
           "joint_subspace")
    _close(kd.base_block(t["base_p"]).numpy(), ref["base_block"],
           "base_block")
    _close(port["J"].numpy(), ref["J"], "link_spatial_jacobians")


def test_inertias_match_with_and_without_overrides(states, port):
    kd, ref, t = states["tkd"], states["ref"], states["t"]
    _close(port["I_sp"].numpy(), ref["I_sp"], "I_sp")
    _close(port["c_w"].numpy(), ref["c_w"], "c_w")
    _close(port["I_w"].numpy(), ref["I_w"], "I_w")
    I_sc, _, I_wsc = kd.link_spatial_inertias(
        port["ls"], mass=kd._mass * t["mass_scale"],
        inertia=kd._inertia * t["mass_scale"][:, :, None, None])
    _close(I_sc.numpy(), ref["I_sp_scaled"], "I_sp scaled")
    _close(I_wsc.numpy(), ref["I_w_scaled"], "I_w scaled")


def test_aggregates_match(states, port):
    kd, ref = states["tkd"], states["ref"]
    J, I_sp, c_w = port["J"], port["I_sp"], port["c_w"]
    _close(kd.mass_matrix(J, I_sp).numpy(), ref["mass_matrix"], "mass_matrix")
    com = kd.com(c_w)
    _close(com.numpy(), ref["com"], "com")
    A_O = kd.momentum_matrix_origin(J, I_sp)
    _close(A_O.numpy(), ref["A_O"], "momentum_matrix_origin")
    _close(kd.centroidal_momentum_matrix(A_O, com).numpy(), ref["A_G"],
           "centroidal_momentum_matrix")
    _close(kd.com_jacobian(J, c_w).numpy(), ref["jcom"], "com_jacobian")


def test_frame_and_relative_jacobians_match(states, port):
    kd, ref, jet = states["tkd"], states["ref"], states["jet"]
    ls, J = port["ls"], port["J"]
    fs = kd.frames((JETS[0],))
    _, p_f = kd.frame_poses(ls, fs)
    # one frame by link index, and the same frame through the index tensor
    one = kd.frame_jacobian(J, ls, jet.link, p_f[:, 0])
    _close(one.numpy(), ref["frame_jacobian"], "frame_jacobian")
    many = kd.frame_jacobian(J, ls, fs.link, p_f)
    np.testing.assert_array_equal(many[:, 0].numpy(), one.numpy())
    _close(kd.relative_jacobian(J, ls, jet.link, p_f[:, 0]).numpy(),
           ref["relative_jacobian"], "relative_jacobian")


def test_bias_forces_match(states, port):
    kd, ref, t = states["tkd"], states["ref"], states["t"]
    nu = torch.cat([t["base_v"], t["qd"]], dim=-1)
    got = kd.bias_forces(port["J"], port["I_sp"], port["ls"], t["base_p"], nu,
                         states["gravity"])
    _close(got.numpy(), ref["bias"], "bias_forces")
    I_sc, _, _ = kd.link_spatial_inertias(
        port["ls"], mass=kd._mass * t["mass_scale"],
        inertia=kd._inertia * t["mass_scale"][:, :, None, None])
    got = kd.bias_forces(port["J"], I_sc, port["ls"], t["base_p"], nu,
                         states["gravity"])
    _close(got.numpy(), ref["bias_scaled"], "bias_forces scaled")


def test_wrench_summary_matches(states, port):
    kd, ref, t = states["tkd"], states["ref"], states["t"]
    com = kd.com(port["c_w"])
    jcom = kd.com_jacobian(port["J"], port["c_w"])
    ws = twrenches.compute_wrench_summary(
        kd, port["ls"], port["J"], com, SOLES, t["wrenches"], jcom, 5.0)
    assert ws._fields == ref["wrench_summary"]._fields
    for name in ws._fields:
        _close(getattr(ws, name).numpy(), getattr(ref["wrench_summary"], name),
               f"wrench_summary.{name}")
    assert ws.on_ground.dtype == torch.bool
    assert ws.on_ground.tolist() == [True, False, True, True]
    assert torch.all(ws.zmp[1] == 0)


@pytest.mark.parametrize("with_wrenches", [False, True],
                         ids=["plain", "sole_wrenches"])
def test_compute_snapshot_matches_field_by_field(states, with_wrenches):
    kd, t = states["tkd"], states["t"]
    ref = states["ref"]["snap_w" if with_wrenches else "snap"]
    kw = (dict(ext_wrench_frames=SOLES, ext_wrenches_body=t["wrenches"],
               ground_threshold=5.0) if with_wrenches else {})
    snap = tdyn.compute_snapshot(kd, JETS, t["base_R"], t["base_p"],
                                 t["base_v"], t["q"], t["qd"], t["thrust"],
                                 **kw)
    assert snap._fields == ref._fields
    for name in snap._fields:
        got, want = getattr(snap, name), getattr(ref, name)
        if want is None:
            assert got is None, name
        else:
            _close(got.numpy(), want, f"snapshot.{name}")


# ---------------------------------------------------------------------------
# compute_snapshot on a recorded takeoff
# ---------------------------------------------------------------------------

TAKEOFF = ROOT / "tests" / "torch_fixtures" / "plant_states_takeoff.npz"
STATE_KEYS = ("base_R", "base_p", "base_vel", "q", "qd", "thrust",
              "sole_wrenches")


@pytest.fixture(scope="module")
def takeoff():
    """The recorded snapshots, and both packages' compute_snapshot of the
    recorded inputs (JAX under one jitted vmap, the port batched)."""
    npz = np.load(TAKEOFF)
    st = [npz[f"state_{k}"] for k in STATE_KEYS]
    frames = tuple(str(f) for f in npz["meta_sole_frames"])
    threshold = float(npz["meta_ground_threshold"][0])
    jkd = jdyn.KinDyn(jdyn.load_ironcub_model())

    def one(base_R, base_p, base_vel, q, qd, thrust, wrenches):
        return jdyn.compute_snapshot(
            jkd, JETS, base_R, base_p, base_vel, q, qd, thrust,
            ext_wrench_frames=frames, ext_wrenches_body=wrenches,
            ground_threshold=threshold)

    jax_snap = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in st))
    tkd = tdyn.KinDyn(tdyn.load_ironcub_model(), device="cpu")
    t = [torch.as_tensor(a) for a in st]
    port = tdyn.compute_snapshot(tkd, JETS, *t[:6], ext_wrench_frames=frames,
                                 ext_wrenches_body=t[6],
                                 ground_threshold=threshold)
    recorded = {f: npz[f"snap_{f}"] for f in port._fields}
    return dict(
        recorded=recorded,
        jax={f: np.asarray(getattr(jax_snap, f)) for f in port._fields},
        port={f: getattr(port, f).numpy() for f in port._fields})


def _same_snapshot(got, want, what):
    for name, ref in want.items():
        val = got[name]
        if ref.dtype == bool or val.dtype == bool:
            # the recorder stores the contact flag as float32 0 / 1
            np.testing.assert_array_equal(val.astype(bool), ref.astype(bool),
                                          err_msg=f"{what}.{name}")
        else:
            _close(val, ref, f"{what}.{name}")


def test_recorded_takeoff_crosses_the_ground_threshold(takeoff):
    """The stream leaves the ground: the contact flag (and with it the
    ZMP branch) changes state inside it, and so does each sole's contact
    wrench, from a load to exactly zero."""
    on = takeoff["recorded"]["on_ground"].astype(bool)
    assert on.shape == (201,)
    assert on[0] and not on[-1], on
    assert np.all(takeoff["recorded"]["zmp"][~on] == 0)
    fz = np.load(TAKEOFF)["state_sole_wrenches"][:, :, 2]
    assert np.all(fz[0] > 0) and np.all(fz[-1] == 0), fz[[0, -1]]


def test_compute_snapshot_on_recorded_takeoff_port_matches_jax(takeoff):
    _same_snapshot(takeoff["port"], takeoff["jax"], "port vs JAX")


@pytest.mark.parametrize("side", ["port", "jax"])
def test_compute_snapshot_on_recorded_takeoff_matches_recording(takeoff,
                                                                side):
    """Each package's snapshots of the recorded inputs against the
    snapshots the port's loop recorded from the same plant states."""
    _same_snapshot(takeoff[side], takeoff["recorded"], f"{side} vs recorded")


def test_kindyn_defaults_to_cuda_and_refuses_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdyn.KinDyn(tdyn.build_ironcub_model())
    assert ironcub_mpc_tpu_torch.resolve_device("cpu").type == "cpu"
