#!/usr/bin/env python
"""Record a real-flight snapshot stream from the PyTorch port's closed loop
(counterpart of tools/record_flight_snapshots.py).

Settles 2 s, configures the flight loop, fast-forwards ``start_tick`` ticks
of the mission, then records ``n`` ticks: every snapshot the MPC consumed,
the EKF thrust-rate estimate fed to each tick, and the trajectory and
alphaGravity windows at the recording handoff, in the layout of
``tests/golden/flight_snapshots*.npz`` (``runtime/replay.py`` loads it):

  snap_<field>     [n+1, ...]  every RobotSnapshot field, f32
  est_td           [n, 4]      EKF thrust-rate estimates fed to each tick
  initial_throttle [4]         applied throttle at the recording handoff
  alpha            [400]       alphaGravity slice from the flight's cursor
  ch_<name>        [45, 3]     reference-trajectory windows from the cursor
  meta_start_tick, meta_thrust_range

With ``--plant-states`` it also writes, for every recorded snapshot, the
exact inputs ``runtime/loop.py``'s ``ClosedLoop.snapshot`` hands to
``dynamics.compute_snapshot`` (so the snapshot can be recomputed from them):

  state_base_R [n+1, 3, 3], state_base_p [n+1, 3]   base pose, world
  state_base_vel [n+1, 6]       measured base velocity (linear, angular)
  state_q, state_qd [n+1, 23]   joint positions and velocities
  state_thrust [n+1, 4]         the plant's applied thrust
  state_sole_wrenches [n+1, 2, 6]  the soles' contact wrenches
  meta_sole_frames, meta_ground_threshold

Usage: python tools/record_flight_snapshots_torch.py [start_tick=2700]
           [n=120] [out=flight_snapshots_torch.npz] [--plant-states]
           [--device cuda]

Runs on ``cuda`` unless ``--device`` says otherwise. Writes ``out`` (a path;
a new file by default) and never into ``tests/golden/``, whose streams the
JAX tool records.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

from common_torch import option, positional, writable  # noqa: E402

DEFAULT_OUT = "flight_snapshots_torch.npz"


def snapshot_inputs(loop, s) -> dict:
    """The tensors ``loop.snapshot(s)`` passes to ``compute_snapshot``
    (runtime/loop.py), by name."""
    import torch

    lin, ang, s = loop.plant.measured_base_velocity(s)
    return dict(base_R=s.base_R, base_p=s.base_p,
                base_vel=torch.cat([lin, ang], dim=-1), q=s.q, qd=s.qd,
                thrust=loop.plant.applied_thrust(s),
                sole_wrenches=loop.plant.sole_wrenches(s))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, valued=("device",))
    start_tick = int(pos[0]) if pos else 2700
    n = int(pos[1]) if len(pos) > 1 else 120
    dest = writable(pos[2] if len(pos) > 2 else DEFAULT_OUT)
    plant_states = "--plant-states" in argv

    from ironcub_mpc_tpu_torch.ops import admm
    from ironcub_mpc_tpu_torch.runtime import flight

    loop, pos_traj, alpha_traj = flight.build_flight_loop(
        use_nn=True, device=option(argv, "device"))
    s = flight.standing_state(loop.plant,
                              loop.plant.sim_cfg.initial_position_deg)
    s = loop.settle(s, 2.0)
    channels, alpha_full = flight.mission_inputs(pos_traj, alpha_traj)
    problem, carry = loop.configure(s, channels, alpha_full)

    def tick(carry, k):
        carry, tel = loop.tick(problem, carry)
        status = int(tel.solver_status[0])
        assert status in (admm.SOLVED, admm.SOLVED_INACCURATE), \
            f"tick {k}: status {status}"
        return carry

    print(f"fast-forwarding {start_tick} ticks "
          f"(t = {start_tick * loop.cfg.period_mpc:.1f} s) ...", flush=True)
    for k in range(start_tick):
        carry = tick(carry, k)

    def lane0(t):
        return np.asarray(t[0].detach().cpu().numpy(), np.float32)

    throttle0 = lane0(carry.plant.throttle)
    alpha_idx = int(carry.mpc.alpha_traj_idx[0])
    pos_idx = int(carry.mpc.pos_traj_idx[0])
    snaps, est_tds, states = [], [], []
    for k in range(n + 1):
        snap, _ = loop.snapshot(carry.plant)
        snaps.append({f: lane0(getattr(snap, f)) for f in snap._fields})
        if plant_states:
            states.append({k: lane0(v) for k, v in
                           snapshot_inputs(loop, carry.plant).items()})
        if k < n:
            est_tds.append(lane0(carry.plant.ekf.x[..., 1]))
            carry = tick(carry, start_tick + k)

    out = {f"snap_{f}": np.stack([sd[f] for sd in snaps]) for f in snaps[0]}
    out["est_td"] = np.stack(est_tds)
    out["initial_throttle"] = throttle0
    out["alpha"] = np.asarray(alpha_full[alpha_idx:alpha_idx + 400],
                              np.float32)
    for name, arr in channels.items():
        out[f"ch_{name}"] = np.asarray(arr[pos_idx:pos_idx + 45], np.float32)
    if plant_states:
        from ironcub_mpc_tpu_torch.sim.plant import SOLE_FRAMES

        for k in states[0]:
            out[f"state_{k}"] = np.stack([st[k] for st in states])
        out["meta_sole_frames"] = np.asarray(SOLE_FRAMES)
        out["meta_ground_threshold"] = np.asarray(
            [loop.robot_cfg.threshold_normal_force_on_ground], np.float32)
    out["meta_start_tick"] = np.asarray([start_tick])
    out["meta_thrust_range"] = np.asarray(
        [out["snap_jet_thrusts"].min(), out["snap_jet_thrusts"].max()])

    np.savez_compressed(dest, **out)
    print(f"recorded {n} ticks from t={start_tick * loop.cfg.period_mpc:.2f}s"
          f" (thrust {out['meta_thrust_range'][0]:.1f}–"
          f"{out['meta_thrust_range'][1]:.1f} N, "
          f"alpha {out['alpha'][0]:.2f}→{out['alpha'][min(n, 399)]:.2f})"
          f" -> {dest} ({Path(dest).stat().st_size / 1e6:.2f} MB)")
    return out


if __name__ == "__main__":
    main()
