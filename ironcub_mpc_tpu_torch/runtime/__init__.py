"""Recorded-flight replay (the trajectory loader is not ported yet)."""
