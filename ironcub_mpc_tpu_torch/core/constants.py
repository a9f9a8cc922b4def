"""MPC state-vector layout and compile-time sizes.

Mirrors the reference's compile-time state indexing
(``momentum-based-linear-mpc-lib/include/variableSamplingMPC/VSconstant.h:6-16``):
26 states = CoM position (3), body-frame linear momentum (3), base RPY (3),
body-frame angular momentum (3), jet thrusts (4), thrust rates (4),
integral-of-CoM-error (3), integral-of-RPY-error (3).

Everything here is a Python int / slice so it is a trace-time constant for
XLA: no dynamic indexing ever reaches the compiled graph.
"""

from __future__ import annotations

N_CTRL_JOINTS = 8  # controlled arm joints (VSconstant.h:6)
N_THRUSTS = 4      # jet turbines (VSconstant.h:7)

# --- state layout (VSconstant.h:9-16) -------------------------------------
COM_POS = slice(0, 3)
LIN_MOM = slice(3, 6)
RPY = slice(6, 9)
ANG_MOM = slice(9, 12)
THRUST = slice(12, 16)
THRUST_DOT = slice(16, 20)
POS_ERR = slice(20, 23)
RPY_ERR = slice(23, 26)

N_STATES = 26  # rpyErrorIdx[2] + 1 (variableSamplingMPC.cpp:42)

# convenience integer index arrays (start offsets)
COM_POS0, LIN_MOM0, RPY0, ANG_MOM0 = 0, 3, 6, 9
THRUST0, THRUST_DOT0, POS_ERR0, RPY_ERR0 = 12, 16, 20, 23


def state_slices() -> dict:
    """Named slices of the 26-dim state, for telemetry and tests."""
    return {
        "com_pos": COM_POS,
        "lin_mom": LIN_MOM,
        "rpy": RPY,
        "ang_mom": ANG_MOM,
        "thrust": THRUST,
        "thrust_dot": THRUST_DOT,
        "pos_err": POS_ERR,
        "rpy_err": RPY_ERR,
    }
