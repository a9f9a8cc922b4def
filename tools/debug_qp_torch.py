#!/usr/bin/env python
"""printMatricesByTask analog of the PyTorch port (IMPCProblem.cpp:493-527;
counterpart of tools/debug_qp.py): assemble the QP at the hover state of
``examples/realtime_driver_torch.py:hover_setup`` and dump every block —
per-cost Hessian/gradient, per-constraint matrix + bounds, and the stacked
recap — to an .npz with debug_qp.py's keys, plus its console summary.

Usage: python tools/debug_qp_torch.py [out.npz=debug_qp_dump.npz]
           [--device cuda]

Runs on ``cuda`` unless ``--device`` says otherwise; refuses to write under
``tests/golden/`` or ``data/``.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

from common_torch import option, positional, writable  # noqa: E402


def cost_blocks(cfg, problem, carry, prep, sel):
    """{name: (Hessian, gradient)} of the four cost terms, full size,
    float64, from lane 0."""
    from ironcub_mpc_tpu_torch.ops import jet_model as jm
    from ironcub_mpc_tpu_torch.qp import assembly

    n = cfg.n_var
    ns, ni, ch = cfg.n_states, cfg.n_iter, cfg.control_horizon
    nj, nt = cfg.n_ctrl_joints, cfg.n_jets
    jo, to = cfg.joints_offset, cfg.throttle_offset
    Q = assembly.state_weight_matrix(cfg)

    H_track = np.zeros((n, n))
    for i in range(1, ni + 1):
        H_track[i * ns:(i + 1) * ns, i * ns:(i + 1) * ns] = Q
    g_track = np.zeros(n)
    state_ref = prep.state_ref[0].cpu().numpy()
    for i in range(1, ni + 1):
        g_track[i * ns:(i + 1) * ns] = -Q @ state_ref[:, i - 1]

    H_reg = np.zeros((n, n))
    for i in range(ch):
        blk = slice(jo + i * nj, jo + (i + 1) * nj)
        H_reg[blk, blk] = np.diag(cfg.weight_delta_joint)
    wt = cfg.weight_throttle * np.eye(nt)
    for i in range(ch - cfg.n_iter_small):
        a = slice(to + i * nt, to + (i + 1) * nt)
        b = slice(to + (i + 1) * nt, to + (i + 2) * nt)
        H_reg[a, a] += wt
        H_reg[b, b] += wt
        H_reg[a, b] -= wt
        H_reg[b, a] -= wt

    H_thr0 = np.zeros((n, n))
    H_thr0[to:to + nt, to:to + nt] = cfg.weight_initial_throttle * np.eye(nt)
    g_thr0 = np.zeros(n)
    g_thr0[to:to + nt] = (-cfg.weight_initial_throttle
                          * jm.throttle_to_v(carry.throttle_cmd))[0].cpu(
                          ).numpy()

    H_jreg = np.zeros((n, n))
    for i in range(ch):
        blk = slice(jo + i * nj, jo + (i + 1) * nj)
        H_jreg[blk, blk] = cfg.weight_regularization_joint_pos * np.eye(nj)
    g_jreg = np.zeros(n)
    jr = (cfg.weight_regularization_joint_pos
          * (carry.joints_pos_ref[:, list(sel)]
             - problem.joint_pos_ref_ctrl))[0].cpu().numpy()
    for i in range(ch):
        g_jreg[jo + i * nj:jo + (i + 1) * nj] = jr

    return {
        "ReferenceTrackingCost": (H_track, g_track),
        "RegualarizationCost": (H_reg, np.zeros(n)),
        "ThrottleInitialValueCost": (H_thr0, g_thr0),
        "JointPositionRegularizationCost": (H_jreg, g_jreg),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = positional(argv, valued=("device",))
    out = writable(pos[0] if pos else "debug_qp_dump.npz")

    import torch

    from ironcub_mpc_tpu_torch.qp import assembly
    from ironcub_mpc_tpu_torch.qp import mpc as vs_mpc
    from realtime_driver_torch import hover_setup

    cfg, sched, sel, settings, problem, carry, snap = hover_setup(
        device=option(argv, "device"))
    est = torch.zeros((1, 4), dtype=torch.float32, device=carry.warm_x.device)
    carry, prep = vs_mpc._tick_prep(cfg, sel, problem, carry, snap, est)

    blocks = cost_blocks(cfg, problem, carry, prep, sel)
    constraints = {
        "ConstraintSystemDynamicVS": assembly.build_dynamics_rows(
            cfg, sched, prep.lin),
        "ConstraintInitialState": assembly.build_initial_state_rows(
            cfg, prep.x0),
        "ThrottleConstraint": assembly.build_throttle_rows(
            cfg, prep.pin, carry.throttle_cmd, prep.x0.dtype),
    }

    payload = {}
    for name, (H, g) in blocks.items():
        print(f"========= {name} =========")
        print(f"  Hessian: {H.shape}, nnz={int(np.count_nonzero(H))}, "
              f"|H|max={np.abs(H).max():.4g}")
        print(f"  Gradient: |g|max={np.abs(np.asarray(g)).max():.4g}")
        payload[f"{name}_hessian"] = H
        payload[f"{name}_gradient"] = np.asarray(g)
    for name, rows in constraints.items():
        A, lb, ub = (r[0].cpu().numpy() for r in rows)
        print(f"========= {name} =========")
        print(f"  A: {A.shape}, nnz={int(np.count_nonzero(A))}")
        print(f"  bounds: [{lb.min():.4g}, {ub.max():.4g}], "
              f"equality rows={int(np.sum(ub - lb < 1e-12))}")
        payload[f"{name}_matrix"] = A
        payload[f"{name}_lb"] = lb
        payload[f"{name}_ub"] = ub

    H_sum = sum(H for H, _ in blocks.values())
    g_sum = sum(np.asarray(g) for _, g in blocks.values())
    print("=========== Recap ===========")
    print(f"  N Optimization Variables : {cfg.n_var}")
    print(f"  N Constraints : {cfg.n_constraints}")
    np.testing.assert_allclose(H_sum, assembly.build_hessian(cfg), atol=1e-9)
    print("  sum(per-block H) == build_hessian  OK")
    payload["hessian"] = H_sum
    payload["gradient"] = g_sum

    np.savez_compressed(out, **payload)
    print(f"wrote {out}")
    return payload


if __name__ == "__main__":
    main()
