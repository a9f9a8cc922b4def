"""Device kernels a tick in the traced window (the profiler's kernels over
the window's ticks): the closed loop's snapshot, MPC tick and plant."""
from mpcbench.core.readers import kernels_per_tick as read  # noqa: F401
