"""Recorded-flight replay, trajectories, the closed loop, the flight runner
and checkpoint / resume of its state."""
