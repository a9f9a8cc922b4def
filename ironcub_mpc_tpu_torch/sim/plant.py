"""Rigid-body plant on the device (counterpart of
``ironcub_mpc_tpu/sim/plant.py``).

1 kHz semi-implicit integration of the full floating-base dynamics
M(q)ν̇ + h(q,ν) = Sτ + Σ JᵀF with

- joint PD position actuators,
- jet thrust as pure world-frame forces along each jet frame's axis,
- penalty ground contacts at four corner points per sole (spring-damper
  normal force + smooth Coulomb friction),
- optional LSTM+EKF in-the-loop thrust estimation (use_nn_jet_dynamics) or
  direct thrust actuation,
- Gaussian sensor-noise injection on base velocities (simulate_noise).

Every field of :class:`PlantState` carries a leading batch dimension B (one
lane per scenario), so a Monte-Carlo sweep is one batched rollout; a rollout
of n substeps (:func:`run_substeps`) is a Python loop of
:meth:`Plant.substep`, or on CUDA n replays of one captured CUDA graph of a
substep (:class:`_SubstepGraph`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import RobotConfig, SimConfig
from ..dynamics.kinodynamics import KinDyn, _cross, _mv
from ..ops.so3 import skew
from ..utils import graphs
from ..utils.profiling import span
from .ekf import EKFState, JetEKF
from .jet_lstm import LSTMJetModel


class PlantState(NamedTuple):
    base_R: torch.Tensor      # [3,3]
    base_p: torch.Tensor      # [3]
    base_v: torch.Tensor      # [6] mixed [v_origin(world); ω(world)]
    q: torch.Tensor           # [n]
    qd: torch.Tensor          # [n]
    thrust_nn: torch.Tensor   # [4] LSTM plant thrust (N)
    ekf: EKFState             # estimated (T, Ṫ)
    throttle: torch.Tensor    # [4] currently applied throttle (%)
    q_des: torch.Tensor       # [n] PD position targets
    thrust_cmd: torch.Tensor  # [4] direct thrust command (when NN model off)
    # kept for the field order of the JAX PlantState; always None here: the
    # sensor-noise generator belongs to the Plant, not to the state
    rng: object
    # scenario perturbations (robustness sweeps; zero/one = nominal)
    wind_force: torch.Tensor    # [3] world-frame gust force applied at the base
    thrust_scale: torch.Tensor  # [4] multiplicative thrust-model error
    # model-mismatch perturbations: the PLANT flies these perturbed
    # inertial/placement parameters while the controller keeps linearising
    # against the nominal model (ones/zeros = nominal)
    mass_scale: torch.Tensor = None      # [L] per-link mass (+inertia) scale
    jet_pos_offset: torch.Tensor = None  # [4,3] jet placement error, link frame


@dataclasses.dataclass(frozen=True)
class PlantParams:
    kp: float = 1500.0         # joint PD stiffness (damping applied implicitly)
    kd: float = 30.0           # joint PD damping
    # ground contact: stiff, well-damped penalty springs
    contact_kp: float = 6.0e4  # ground spring
    contact_kd: float = 900.0  # ground damper
    friction_mu: float = 0.8
    friction_vel: float = 0.02  # smooth-friction reference slip speed
    foot_half_x: float = 0.07
    foot_half_y: float = 0.04


SOLE_FRAMES = ("l_sole", "r_sole")


class Plant:
    """Static configuration + step functions on batched states."""

    def __init__(self, kd: KinDyn, robot_cfg: RobotConfig | None = None,
                 sim_cfg: SimConfig | None = None,
                 params: PlantParams = PlantParams(),
                 lstm: LSTMJetModel | None = None):
        self.kd = kd
        self.robot_cfg = robot_cfg or RobotConfig()
        self.sim_cfg = sim_cfg or SimConfig()
        self.params = params
        self.dt = self.sim_cfg.timestep
        self.lstm = lstm
        self.ekf = JetEKF(self.dt, dtype=kd.dtype, device=kd.device)
        self._jets = kd.frames(self.robot_cfg.jets_list)
        self._soles = kd.frames(SOLE_FRAMES)
        hx, hy = params.foot_half_x, params.foot_half_y
        self._corners = np.array([[hx, hy, 0], [hx, -hy, 0],
                                  [-hx, hy, 0], [-hx, -hy, 0]])

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=kd.dtype,
                                   device=kd.device)

        self._corners_t = f(self._corners)                   # [4,3]
        self._jet_axis_local = f([0.0, 0.0, -1.0])
        self._gravity = f(self.robot_cfg.gravity)
        # implicit joint damping D (zero on the base rows)
        self._D = torch.cat([torch.zeros(6, dtype=kd.dtype, device=kd.device),
                             torch.full((kd.n,), float(params.kd),
                                        dtype=kd.dtype, device=kd.device)])
        self._dt_D = self.dt * torch.diag(self._D)
        # links that external forces act on, in the order substep stacks
        # them: 4 jets, the base (wind), 2 soles × 4 corners
        self._force_links = torch.cat([
            self._jets.link, torch.zeros(1, dtype=torch.long,
                                         device=kd.device),
            self._soles.link.repeat_interleave(4)])
        # sensor noise: one generator per plant, seeded by init_state
        self._noise_gen = torch.Generator(device=kd.device)
        # state layout (_layout) -> its captured substep (run_substeps)
        self._graphs = {}

    def seed_noise(self, seed: int):
        """Seed the sensor-noise generator (``init_state`` does)."""
        self._noise_gen.manual_seed(int(seed))

    def noise_state(self) -> torch.Tensor:
        """The sensor-noise generator's state: the JAX plant carries its
        noise key in the state, this plant keeps the generator, so a
        checkpoint or a retry that must see the same draws saves this."""
        return self._noise_gen.get_state()

    def set_noise_state(self, state: torch.Tensor):
        """Put the sensor-noise generator back to a :meth:`noise_state`."""
        self._noise_gen.set_state(state)

    # ------------------------------------------------------------------

    def init_state(self, base_R, base_p, q, seed: int = 0,
                   thrust0: float = 10.0, batch: int = 1) -> PlantState:
        """State of ``batch`` identical lanes from one unbatched pose;
        ``seed`` seeds the plant's sensor-noise generator."""
        kd = self.kd
        opts = dict(dtype=kd.dtype, device=kd.device)
        self.seed_noise(seed)

        def lanes(a):
            t = torch.as_tensor(np.asarray(a), **opts)
            return t.expand(batch, *t.shape).contiguous()

        t0 = torch.full((batch, 4), float(thrust0), **opts)
        return PlantState(
            base_R=lanes(base_R), base_p=lanes(base_p),
            base_v=torch.zeros((batch, 6), **opts), q=lanes(q),
            qd=torch.zeros((batch, kd.n), **opts), thrust_nn=t0,
            ekf=self.ekf.init(t0),
            throttle=torch.zeros((batch, 4), **opts), q_des=lanes(q),
            thrust_cmd=t0.clone(), rng=None,
            wind_force=torch.zeros((batch, 3), **opts),
            thrust_scale=torch.ones((batch, 4), **opts),
            mass_scale=torch.ones((batch, kd.L), **opts),
            jet_pos_offset=torch.zeros((batch, 4, 3), **opts))

    # ------------------------------------------------------------------
    # actuation setters
    # ------------------------------------------------------------------

    def set_joint_positions(self, s: PlantState, q_des) -> PlantState:
        return s._replace(q_des=q_des)

    def set_throttle(self, s: PlantState, throttle) -> PlantState:
        return s._replace(throttle=throttle)

    def set_thrust(self, s: PlantState, thrust) -> PlantState:
        return s._replace(thrust_cmd=thrust)

    def applied_thrust(self, s: PlantState):
        """Thrust actually exerted on the robot this step
        (EKF estimate when the NN jet model is on, else the command)."""
        if self.sim_cfg.use_nn_jet_dynamics:
            return s.ekf.x[..., 0]
        return s.thrust_cmd

    # ------------------------------------------------------------------
    # contact model (shared by the dynamics and the FT-sensor readout)
    # ------------------------------------------------------------------

    def _sole_corner_forces(self, ls, J, nu):
        """World points and world forces of the penalty contact at the four
        corners of both soles: (pc, f), each [2, 4, 3], plus the soles' world
        poses (R_f [2,3,3], p_f [2,3])."""
        p = self.params
        R_f, p_f = self.kd.frame_poses(ls, self._soles)
        V = _mv(J[:, self._soles.link], nu[:, None, :])      # [B,2,6]
        pc = p_f[:, :, None, :] + _mv(R_f[:, :, None], self._corners_t)
        vc = V[:, :, None, 0:3] + _cross(V[:, :, None, 3:6].expand_as(pc), pc)
        pen = -pc[..., 2]
        fz = torch.clamp_min(p.contact_kp * pen - p.contact_kd * vc[..., 2],
                             0.0)
        fz = torch.where(pen > 0, fz, torch.zeros_like(fz))
        vt = vc[..., 0:2]
        ft = -p.friction_mu * fz[..., None] * vt / (
            torch.linalg.vector_norm(vt, dim=-1, keepdim=True)
            + p.friction_vel)
        return pc, torch.cat([ft, fz[..., None]], dim=-1), R_f, p_f

    def sole_wrenches(self, s: PlantState):
        """Ground-contact wrench per sole in the sole frame — the FT-sensor
        readout fed to the snapshot as external wrenches. Returns [2, 6]
        (force, torque about the sole origin)."""
        kd = self.kd
        ls = kd.fk(s.base_R, s.base_p, s.q)
        J = kd.link_spatial_jacobians(ls, s.base_p)
        nu = torch.cat([s.base_v, s.qd], dim=-1)
        pc, f, R_f, p_f = self._sole_corner_forces(ls, J, nu)
        f_tot = f.sum(dim=2)
        tau_tot = _cross(pc - p_f[:, :, None, :], f).sum(dim=2)
        Rt = R_f.mT
        return torch.cat([_mv(Rt, f_tot), _mv(Rt, tau_tot)], dim=-1)

    # ------------------------------------------------------------------
    # one 1 kHz substep
    # ------------------------------------------------------------------

    def substep(self, s: PlantState) -> PlantState:
        """One 1 kHz step. While a profiler records, it is the span
        ``plant.substep`` with the LSTM step and the EKF update in
        ``plant.jets``. Counter: ``Plant.substep.substeps``."""
        Plant.substep.substeps += 1
        with span("plant.substep"):
            return self._substep(s)

    def _substep(self, s: PlantState) -> PlantState:
        kd = self.kd
        dt = self.dt
        p = self.params

        # --- jet plant + estimator -----------------------------------------
        if self.sim_cfg.use_nn_jet_dynamics:
            with span("plant.jets"):
                t_nn, td_nn = self.lstm.step(s.thrust_nn, s.throttle, dt)
                ekf = self.ekf.update(s.ekf, s.throttle, t_nn, td_nn)
            thrust = ekf.x[..., 0]
            s = s._replace(thrust_nn=t_nn, ekf=ekf)
        else:
            thrust = s.thrust_cmd

        # --- kinodynamics at current state ---------------------------------
        # mass_scale applies the per-scenario inertial-parameter error to
        # the TRUE dynamics (mass and rotational inertia scale together);
        # the controller's snapshot keeps using the nominal model
        ls = kd.fk(s.base_R, s.base_p, s.q)
        J = kd.link_spatial_jacobians(ls, s.base_p)
        I_sp, _, _ = kd.link_spatial_inertias(
            ls, mass=kd._mass * s.mass_scale,
            inertia=kd._inertia * s.mass_scale[:, :, None, None])
        M = kd.mass_matrix(J, I_sp)
        nu = torch.cat([s.base_v, s.qd], dim=-1)
        bias = kd.bias_forces(J, I_sp, ls, s.base_p, nu, self._gravity)

        # --- generalized forces -------------------------------------------
        # PD damping is handled implicitly in the solve (below) so stiff
        # gains stay stable on low-inertia joints at 1 kHz.
        tau_pd = torch.cat([torch.zeros_like(s.base_v),
                            p.kp * (s.q_des - s.q)], dim=-1)

        # jet thrust: pure force f = a_i T_i at the jet frame origin
        # (thrust_scale models per-scenario turbine mismatch;
        # jet_pos_offset a per-scenario placement error in the link frame)
        R_j, p_j = kd.frame_poses(ls, self._jets, s.jet_pos_offset)
        f_jet = _mv(R_j, self._jet_axis_local) * (
            thrust * s.thrust_scale)[..., None]              # [B,4,3]
        # ground contact at sole corners
        pc, f_c, _, _ = self._sole_corner_forces(ls, J, nu)
        # every external force as a wrench at the world origin; the wind
        # gust is a world-frame force at the base origin
        pts = torch.cat([p_j, s.base_p[:, None, :], pc.flatten(1, 2)], dim=1)
        frc = torch.cat([f_jet, s.wind_force[:, None, :], f_c.flatten(1, 2)],
                        dim=1)
        F_O = torch.cat([frc, _cross(pts, frc)], dim=-1)     # [B,13,6]
        tau = tau_pd + torch.einsum("bkai,bka->bi",
                                    J[:, self._force_links], F_O)

        # --- forward dynamics + semi-implicit Euler -----------------------
        # implicit joint damping: τ_d = -D q̇_{k+1}  ⇒  (M + dt·D) ν̇ =
        # τ - D ν_k - bias  (D zero on base rows) — unconditionally stable
        # for any damping gain. No error flag is read on the host (_solve).
        lhs = M + self._dt_D
        nu_dot = _solve(lhs, (tau - self._D * nu - bias)[..., None])[..., 0]
        nu_new = nu + nu_dot * dt
        v, w = nu_new[:, 0:3], nu_new[:, 3:6]
        base_p = s.base_p + v * dt
        base_R = _exp_so3(w * dt) @ s.base_R
        q = s.q + nu_new[:, 6:] * dt
        return s._replace(base_R=base_R, base_p=base_p, base_v=nu_new[:, 0:6],
                          q=q, qd=nu_new[:, 6:])

    def step(self, s: PlantState, n_steps: int) -> PlantState:
        """``n_steps`` substeps from ``s`` (:func:`run_substeps`)."""
        return run_substeps(self, s, n_steps)

    # ------------------------------------------------------------------
    # sensors (with optional noise)
    # ------------------------------------------------------------------

    def measured_base_velocity(self, s: PlantState):
        """(v_world, ω_world) with optional Gaussian noise drawn from the
        plant's generator; returns (lin, ang, state)."""
        lin, ang = s.base_v[:, 0:3], s.base_v[:, 3:6]
        if self.sim_cfg.simulate_noise:
            std = self.sim_cfg.noise_std_base_vel
            noise = torch.randn(s.base_v.shape, generator=self._noise_gen,
                                dtype=s.base_v.dtype, device=s.base_v.device)
            lin = lin + std * noise[:, 0:3]
            ang = ang + std * noise[:, 3:6]
        return lin, ang, s


Plant.substep.substeps = 0


def _graphs_engage(device: torch.device) -> bool:
    """A substep reads nothing back on the host and draws no noise, so on
    CUDA it replays from a graph; on any other device it runs eagerly."""
    return device.type == "cuda"


def run_substeps(plant: Plant, s: PlantState, n: int) -> PlantState:
    """``n`` 1 kHz substeps of ``plant`` from ``s``. On CUDA the state is
    copied into the buffers of one captured substep (:class:`_SubstepGraph`,
    captured at the first call for the state's layout), which is replayed
    ``n`` times, each replay the span ``plant.substep``; the result is a
    clone the caller owns. Elsewhere :meth:`Plant.substep` runs ``n`` times.
    Counters: ``run_substeps.substeps``, ``.graphed_substeps`` (those
    replayed) and ``.graph_captures``; ``Plant.substep.substeps`` moves by
    ``n`` on both paths."""
    run_substeps.substeps += n
    if not _graphs_engage(s.base_p.device):
        for _ in range(n):
            s = plant.substep(s)
        return s
    key = _layout(s)
    graph = plant._graphs.get(key)
    if graph is None:
        graph = plant._graphs[key] = _SubstepGraph(plant, s)
        run_substeps.graph_captures += 1
    run_substeps.graphed_substeps += n
    Plant.substep.substeps += n
    return graph(s, n)


run_substeps.substeps = 0
run_substeps.graphed_substeps = 0
run_substeps.graph_captures = 0


def _layout(s: PlantState) -> tuple:
    """The device, and the shape and dtype of each field of ``s`` (the
    EKF's within it), None where the field is None."""
    fields = (*s._replace(ekf=None), *s.ekf)
    return s.base_p.device, tuple(
        None if t is None else (t.shape, t.dtype) for t in fields)


class _SubstepGraph:
    """One substep of one plant for one state layout, captured as a CUDA
    graph that writes the next state over the state it read, so ``n``
    replays chain with no host work between them. Every field is read from
    the static buffers (the perturbations too: a new wind or a restored
    state needs no new capture); the plant's constants at their captured
    addresses."""

    def __init__(self, plant: Plant, s: PlantState):
        dev = s.base_p.device
        self.inputs = graphs.StaticInputs(s)
        self.outputs = graphs.FlatOutputs(self.inputs.tree)
        rec = graphs.Piecewise(dev)
        cur = torch.cuda.current_stream(dev)
        self.inputs.copy_from(s)
        rec.stream.wait_stream(cur)
        # the warm-up makes every cached constant, index and library handle
        # the capture would otherwise make inside the graph; it and the
        # capture call _substep, which moves no counter
        with torch.cuda.stream(rec.stream):
            plant._substep(self.inputs.tree)
        with rec.capture():
            with rec.stage("plant.substep"):
                self.inputs.copy_from(plant._substep(self.inputs.tree))
        cur.wait_stream(rec.stream)
        (_, (self._replay,)), = rec.stages

    def __call__(self, s: PlantState, n: int) -> PlantState:
        self.inputs.copy_from(s)
        for _ in range(n):
            with span("plant.substep"):
                self._replay()
        self.outputs.write(self.inputs.tree)
        return self.outputs.take()


def _solve(lhs, rhs):
    """``lhs⁻¹ rhs`` of a batch of square systems by LU (``solve_ex``: no
    error flag read on the host). On CUDA, a batch of more than one system
    goes through cuSOLVER's and cuBLAS's batched routines: PyTorch's own
    choice turns to MAGMA past 16 systems of this size, which a CUDA graph
    cannot capture (the sweep's 1024 lanes). The choice is PyTorch's
    process-wide preferred library, set around the call and put back; it
    picks the kernels a graph captures, and eager calls take the same so
    that they match a replay bit for bit. One system takes PyTorch's own
    route."""
    if lhs.device.type != "cuda" or lhs.shape[0] == 1:
        return torch.linalg.solve_ex(lhs, rhs)[0]
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.solve_ex(lhs, rhs)[0]
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _exp_so3(w):
    """Matrix exponential of a rotation increment (Rodrigues, safe at 0)."""
    th = torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12
    K = skew(w / th)
    s = torch.sin(th)[..., None]
    c = torch.cos(th)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s * K + (1.0 - c) * (K @ K)
