"""Second-order polynomial jet (turbine) thrust model (counterpart of
``ironcub_mpc_tpu/ops/jet_model.py``).

``T̈ = f(T, Ṫ) + g(T, Ṫ) · v(u)`` in standardised units, with quadratic
surfaces ``f, g`` and the throttle map ``v(u) = ū + c₁₂ ū²`` — the identified
JetCat P-220 model. Every function broadcasts over leading dimensions. The
hand-written partials are the MPC linearisation; tests hold them against
``torch.func`` autograd.
"""

from __future__ import annotations

import torch

# 13 identified coefficients: f uses c0..c5, g uses c6..c11, the throttle
# map uses c12.
U2T_COEFF = (
    -4.64730485e-01, -8.13171858e+00, -6.19539230e+00, 6.61113140e-01,
    1.67673231e+00, -4.83287064e-01, 8.77996617e+00, -1.01096376e+00,
    -5.86442286e-01, 5.19093322e-01, -4.23782666e-01, -1.45705257e+00,
    -7.83052261e-03,
)

# standardisation constants {mean_T, std_T, mean_u, std_u}
THRUST_MEAN = 108.309
THRUST_STD = 65.793
THROTTLE_MEAN = 47.333
THROTTLE_STD = 31.483

_C = U2T_COEFF


# --- polynomials in standardised units -------------------------------------

def f(t, td):
    """f(T̄, T̄d) quadratic surface."""
    return _C[0] + _C[1] * t + _C[2] * td + _C[3] * t * td + _C[4] * t * t + _C[5] * td * td


def g(t, td):
    """g(T̄, T̄d) quadratic surface (throttle effectiveness)."""
    return _C[6] + _C[7] * t + _C[8] * td + _C[9] * t * td + _C[10] * t * t + _C[11] * td * td


def v(u):
    """Throttle map v(ū) = ū + c₁₂ ū² in standardised units."""
    return u + _C[12] * u * u


def df_dt(t, td):
    return _C[1] + _C[3] * td + 2.0 * _C[4] * t


def df_dtd(t, td):
    return _C[2] + _C[3] * t + 2.0 * _C[5] * td


def dg_dt(t, td):
    return _C[7] + _C[9] * td + 2.0 * _C[10] * t


def dg_dtd(t, td):
    return _C[8] + _C[9] * t + 2.0 * _C[11] * td


# --- standardise / destandardise -------------------------------------------

def standardize_thrust(thrust):
    return (thrust - THRUST_MEAN) / THRUST_STD


def standardize_thrust_dot(thrust_dot):
    return thrust_dot / THRUST_STD


def standardize_throttle(throttle):
    return (throttle - THROTTLE_MEAN) / THROTTLE_STD


def destandardize_thrust(t):
    return t * THRUST_STD + THRUST_MEAN


def destandardize_thrust_dot(td):
    return td * THRUST_STD


def destandardize_throttle(v_std):
    """Invert v(ū) = ū + c₁₂ū² for ū, destandardise, clamp to [0, 100]."""
    u = (-1.0 + torch.sqrt(1.0 + 4.0 * _C[12] * v_std)) / (2.0 * _C[12])
    u = u * THROTTLE_STD + THROTTLE_MEAN
    return torch.clamp(u, 0.0, 100.0)


# --- physical-unit wrappers used by the MPC linearisation ------------------

def f_newton(thrust, thrust_dot):
    """f in physical units: contribution to T̈ [N/s²] at zero throttle map."""
    return f(standardize_thrust(thrust), standardize_thrust_dot(thrust_dot)) * THRUST_STD


def g_newton(thrust, thrust_dot):
    """dT̈/dv in physical units (input variable is standardised v)."""
    return g(standardize_thrust(thrust), standardize_thrust_dot(thrust_dot)) * THRUST_STD


def dh_dthrust(thrust, thrust_dot, throttle):
    """∂T̈/∂T (dimensionless) of h = f + g·v at (T, Ṫ, u)."""
    t = standardize_thrust(thrust)
    td = standardize_thrust_dot(thrust_dot)
    u = standardize_throttle(throttle)
    return df_dt(t, td) + dg_dt(t, td) * v(u)


def dh_dthrust_dot(thrust, thrust_dot, throttle):
    """∂T̈/∂Ṫ (dimensionless) of h = f + g·v at (T, Ṫ, u)."""
    t = standardize_thrust(thrust)
    td = standardize_thrust_dot(thrust_dot)
    u = standardize_throttle(throttle)
    return df_dtd(t, td) + dg_dtd(t, td) * v(u)


def thrust_ddot(thrust, thrust_dot, throttle):
    """Full nonlinear T̈ [N/s²]."""
    t = standardize_thrust(thrust)
    td = standardize_thrust_dot(thrust_dot)
    u = standardize_throttle(throttle)
    return (f(t, td) + g(t, td) * v(u)) * THRUST_STD


def throttle_to_v(throttle):
    """Physical throttle [%] -> standardised v-space (bounds, pins, costs)."""
    return v(standardize_throttle(throttle))


def step(thrust, thrust_dot, throttle, dt):
    """Semi-implicit Euler step of the second-order jet dynamics: Ṫ is
    advanced first, then T integrates the *new* Ṫ."""
    tdd = thrust_ddot(thrust, thrust_dot, throttle)
    new_td = thrust_dot + tdd * dt
    new_t = thrust + new_td * dt
    return new_t, new_td


def step_jacobians(x, u, dt):
    """Jacobians (A, B) of the discrete :func:`step` w.r.t. the state
    x = [..., (T, Ṫ)] and the throttle u [...], in closed form from the
    polynomial's partials: A is [..., 2, 2], B is [..., 2] (the 2×1 column).

    With h = T̈: Ṫ' = Ṫ + h·dt and T' = T + Ṫ'·dt, so
    A = [[1 + h_T dt², dt + h_Ṫ dt²], [h_T dt, 1 + h_Ṫ dt]] and
    B = [h_u dt², h_u dt]. ``dh_dthrust`` is dimensionless (∂T̈/∂T in
    physical units, the two standardisations cancel); ``dh_dthrust_dot``
    likewise."""
    thrust, thrust_dot = x[..., 0], x[..., 1]
    h_t = dh_dthrust(thrust, thrust_dot, u)
    h_td = dh_dthrust_dot(thrust, thrust_dot, u)
    us = standardize_throttle(u)
    h_u = (g(standardize_thrust(thrust), standardize_thrust_dot(thrust_dot))
           * (1.0 + 2.0 * _C[12] * us) * (THRUST_STD / THROTTLE_STD))
    A = torch.stack([
        torch.stack([1.0 + h_t * dt * dt, dt + h_td * dt * dt], dim=-1),
        torch.stack([h_t * dt, 1.0 + h_td * dt], dim=-1)], dim=-2)
    B = torch.stack([h_u * dt * dt, h_u * dt], dim=-1)
    return A, B
