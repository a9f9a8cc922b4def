"""Recorded-flight replay, trajectories, the closed loop and the flight
runner."""
