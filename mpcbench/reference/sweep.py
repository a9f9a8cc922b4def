# Frozen copy of tests/sweep_oracle.py (the benchmark's reference of the sweep cell); edit nothing below this line.
"""Plain float64 reference of the Monte-Carlo robustness sweep: the
perturbed flights of ``flight_oracle`` and the statistics the sweep reduces
them to.

Plain PyTorch in float64 on the CPU (TF32 switched off wherever a product
could reach it), one robot a call, no batching, no kernels. It imports
neither JAX nor ``ironcub_mpc_tpu_torch``, and builds on
``flight_oracle`` (the plant, the snapshot, the exact controller step)
without changing it. What it adds:

- **A scenario's perturbations.** Each lane flies its own constant
  world-frame wind at the chest origin (as the flight's) and its own
  multiplicative turbine mismatch: each jet's force is its thrust times
  the lane's ``thrust_scale``, while the EKF's estimate, which the
  controller reads, stays unscaled. Its initial base velocity and posture
  noise live in the state a lane starts from. The model-mismatch axes
  (per-link mass scale, jet placement error) are not written out: a lane
  or a configuration that sets them is refused, never flown nominal.
- **The CoM error**, ‖c − c_ref‖ of a tick: the snapshot's CoM against
  the controller's CoM reference after its update of the tick, as the
  sweep measures it.
- **The statistics** (:func:`lane_statistics`, :func:`reduce`): a lane's
  largest CoM error over its ticks (+inf once it is not finite), whether
  any tick stayed unsolved after the retry (a status of primal or dual
  infeasible or iteration cap), the status histogram over (lane, tick)
  with the carried-inverse guard's firings beside it; over the lanes, the
  lanes failed (largest error not finite or above ``com_err_fail``), the
  lanes with an unsolved tick, the mean and the largest error of the
  healthy lanes, and the share of (lane, tick) solved.

Uses: :func:`step_pass` follows a pass of the program tick by tick (each
tick from the program's plant state and commands of the tick before),
:func:`chain_pass` flies the reference's own closed loop from a lane's
perturbed start; both take and return NumPy arrays, so a process pool can
run them.
"""

from __future__ import annotations

import numpy as np
import torch

try:  # the benchmark's copy sits beside its own flight reference
    from . import flight as flight_oracle
except ImportError:
    import flight_oracle

F64 = flight_oracle.F64
_t = flight_oracle._t
COMMANDS = flight_oracle.COMMANDS
PLANT_FIELDS = flight_oracle.PLANT_FIELDS
# the solver's statuses, and the columns of the status histogram
SOLVED, SOLVED_INACCURATE, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, MAX_ITER = \
    1, 2, 3, 4, 5
STATUS_COLS = ("solved", "solved_inaccurate", "primal_infeasible",
               "dual_infeasible", "max_iter", "guard_fired")


def check_lane(lane: dict) -> dict:
    """A lane's perturbations as float64 tensors: ``wind`` [3] (N, world
    frame) and ``thrust_scale`` [4]; ``mass_scale`` and ``jet_pos_offset``,
    where given, must be nominal (ones, zeros)."""
    mass = lane.get("mass_scale")
    if mass is not None and np.any(np.asarray(mass) != 1.0):
        raise ValueError("the reference flies nominal link masses; the "
                         "lane scales them")
    offset = lane.get("jet_pos_offset")
    if offset is not None and np.any(np.asarray(offset) != 0.0):
        raise ValueError("the reference flies the jets where the model "
                         "puts them; the lane moves them")
    scale = lane.get("thrust_scale")
    return dict(wind=_t(lane["wind"]),
                thrust_scale=_t(np.ones(4) if scale is None else scale))


class SweepFlight(flight_oracle.Flight):
    """:class:`flight_oracle.Flight` of one perturbed lane: each jet's
    force scaled by the lane's ``thrust_scale``. The configuration's
    ``scenario`` section, where it has one, must leave the model
    nominal."""

    def __init__(self, config_path, start, lane: dict):
        super().__init__(config_path, start)
        scen = self.config.get("scenario", {})
        if scen.get("mass_scale_std", 0.0) or scen.get("jet_pos_std_m", 0.0):
            raise ValueError("the reference flies the nominal model; the "
                             "configuration perturbs it")
        self.lane = check_lane(lane)

    def substep(self, st: dict, wind) -> dict:
        """:meth:`flight_oracle.Flight.substep` with each jet's force
        ``thrust_scale`` times its thrust."""
        st = dict(st)
        rb, dt, pl = self.robot, self.dt, self.plant_params
        T, Td = self.lstm.step(st["thrust_nn"], st["throttle"], dt)
        x, P = flight_oracle.ekf_update(
            st["ekf_x"], st["ekf_P"], st["throttle"], torch.stack([T, Td], -1),
            dt, self.R_ekf, self.Q_ekf)
        st.update(thrust_nn=T, ekf_x=x, ekf_P=P)
        thrust = x[:, 0] * self.lane["thrust_scale"]
        kin = flight_oracle.kinematics(rb, st["base_R"], st["base_p"],
                                       st["q"])
        nu = torch.cat([st["base_v"], st["qd"]])
        dyn = flight_oracle.dynamics(rb, kin, nu, self.gravity)
        tau = torch.cat([torch.zeros(6, dtype=F64),
                         pl["kp"] * (st["q_des"] - st["q"])])
        p_j = kin.p[self.jets]
        f_j = (kin.R[self.jets] @ self.jet_axis) * thrust[:, None]
        tau = tau + torch.einsum(
            "kai,ka->i",
            flight_oracle.point_jacobian(rb, kin, self.jets, p_j), f_j)
        tau = tau + torch.cat([_t(wind), torch.zeros(rb.n + 3, dtype=F64)])
        tau = tau + self._contact(kin, nu)[0]
        nu_dot = torch.linalg.solve(dyn.M + dt * torch.diag(self.D),
                                    tau - self.D * nu - dyn.h)
        nu = nu + dt * nu_dot
        st.update(base_v=nu[:6], qd=nu[6:],
                  base_p=st["base_p"] + dt * nu[0:3],
                  base_R=flight_oracle._exp(dt * nu[3:6]) @ st["base_R"],
                  q=st["q"] + dt * nu[6:])
        return st


def _observed(sd: dict, com_ref) -> dict:
    return dict(com=sd["com_pos"], momentum=sd["momentum_body"],
                com_ref=np.asarray(com_ref, np.float64).copy())


def step_pass(config_path, start_path, carry_path, lane, ticks) -> list:
    """:func:`flight_oracle.step_pass` for one perturbed lane (``lane``:
    :func:`check_lane`'s keys): the reference beside one pass of the
    program, tick by tick from the recorded start ``carry_path``'s
    controller. ``ticks`` [(check, state, before, applied)] as there.
    Returns [{observed, commands, next}] a tick of ``ticks``, a tick not
    compared {observed} alone (its CoM error, :func:`com_errors`, still
    counts towards the lane's largest); observed holds the controller's
    CoM reference of the tick (``com_ref``) beside the snapshot's CoM and
    body momentum."""
    flight = SweepFlight(config_path, np.load(start_path), lane)
    wind = flight.lane["wind"].numpy()
    omp = flight.controller(np.load(carry_path))
    out = []
    for check, state, prev, applied in ticks:
        st = {k: _t(v) for k, v in state.items()}
        sd = flight.snapshot(st)
        d = omp._prep(sd, np.asarray(state["ekf_x"])[:, 1])
        if not check:
            out.append(dict(observed=_observed(sd, d["pos_com_ref_now"])))
            continue
        cmds = flight_oracle.solve_from(omp, d, prev)
        nxt = flight.plant(st, applied["joints_pos_ref"],
                           applied["throttle"], wind)
        out.append(dict(observed=_observed(sd, d["pos_com_ref_now"]),
                        commands=cmds,
                        next=flight_oracle._numpy_state(nxt)))
    return out


def chain_pass(config_path, start_path, carry_path, lane, state,
               n_ticks) -> list:
    """The reference's own closed loop of ``n_ticks`` ticks for one
    perturbed lane (``lane``: :func:`check_lane`'s keys) from its start
    ``state`` ({field: array}, the plant state the lane's pass starts
    from, its initial noise in it), the controller the recorded start
    ``carry_path``'s: [{observed, commands, next}] a tick, as
    :func:`step_pass` gives them."""
    flight = SweepFlight(config_path, np.load(start_path), lane)
    wind = flight.lane["wind"].numpy()
    omp = flight.controller(np.load(carry_path))
    st = {k: _t(state[k]) for k in PLANT_FIELDS}
    out = []
    for _ in range(n_ticks):
        sd = flight.snapshot(st)
        cmds = omp.tick(sd, st["ekf_x"][:, 1].numpy())
        com_ref = omp.pos_ref_now
        st = flight.plant(st, cmds["joints_pos_ref"], cmds["throttle"], wind)
        out.append(dict(observed=_observed(sd, com_ref),
                        commands={k: cmds[k] for k in COMMANDS},
                        next=flight_oracle._numpy_state(st)))
    return out


def step_pass_task(args):
    """:func:`step_pass` on one tuple of arguments, for a process pool."""
    torch.set_num_threads(1)
    return step_pass(*args)


def chain_pass_task(args):
    """:func:`chain_pass` on one tuple of arguments, for a process pool."""
    torch.set_num_threads(1)
    return chain_pass(*args)


def com_errors(com, com_ref) -> np.ndarray:
    """‖c − c_ref‖ over the last axis, in float64; +inf where not
    finite."""
    err = np.linalg.norm(np.asarray(com, np.float64)
                         - np.asarray(com_ref, np.float64), axis=-1)
    return np.where(np.isfinite(err), err, np.inf)


def lane_statistics(com, com_ref, status, guard) -> dict:
    """A sweep's per-lane statistics from its ticks: ``com``, ``com_ref``
    [ticks, lanes, 3] (the snapshot's CoM and the controller's reference),
    ``status`` [ticks, lanes] (after the retry) and ``guard`` [ticks,
    lanes] (the carried-inverse guard fired). Returns ``max_err`` [lanes],
    ``solver_bad`` [lanes] and ``counts`` [lanes, 6] in
    :data:`STATUS_COLS` order."""
    return dict(max_err=com_errors(com, com_ref).max(axis=0),
                solver_bad=solver_bad(status),
                counts=status_counts(status, guard))


def solver_bad(status) -> np.ndarray:
    """[lanes]: a tick of the lane stayed unsolved after the retry (primal
    or dual infeasible, or the iteration cap), from ``status`` [ticks,
    lanes]."""
    return (np.asarray(status) >= PRIMAL_INFEASIBLE).any(axis=0)


def status_counts(status, guard) -> np.ndarray:
    """The status histogram of each lane, [lanes, 6] in
    :data:`STATUS_COLS` order, from ``status`` and ``guard`` [ticks,
    lanes]."""
    status = np.asarray(status)
    cols = [(status == v).sum(axis=0) for v in
            (SOLVED, SOLVED_INACCURATE, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE,
             MAX_ITER)]
    cols.append(np.asarray(guard, bool).sum(axis=0))
    return np.stack(cols, axis=-1).astype(np.int64)


def reduce(max_err, solver_bad, counts, n_ticks: int,
           com_err_fail: float) -> dict:
    """The sweep's statistics over its lanes, from the per-lane vectors:
    ``max_err`` [lanes] (largest CoM error, m), ``solver_bad`` [lanes]
    and ``counts`` [lanes, 6] (:func:`status_counts`) of ``n_ticks``
    ticks. A lane fails where its largest error is not finite or above
    ``com_err_fail``; the mean and the largest error are over the others
    (0 and -inf where none is)."""
    max_err = np.asarray(max_err, np.float64)
    counts = np.asarray(counts, np.int64)
    failed = ~np.isfinite(max_err) | (max_err > com_err_fail)
    healthy = max_err[~failed]
    solved = counts[:, 0] + counts[:, 1]
    return dict(
        n_failed=int(failed.sum()),
        n_solver_bad=int(np.asarray(solver_bad, bool).sum()),
        mean_com_err=(float(healthy.mean()) if healthy.size else 0.0),
        max_com_err=(float(healthy.max()) if healthy.size else -np.inf),
        solved_frac=float((solved / n_ticks).mean()),
        status_counts=counts.sum(axis=0))
