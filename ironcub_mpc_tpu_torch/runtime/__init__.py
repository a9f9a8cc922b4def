"""Recorded-flight replay, trajectories, the closed loop, the flight runner,
checkpoint / resume of its state, telemetry to ``.mat`` and the native
real-time runtime (telemetry ring, deadline pacer)."""
