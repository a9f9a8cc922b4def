"""Device kernels launched a tick in the traced window (the profiler's
kernels over the window's ticks): the eager MPC tick's dispatch."""
from mpcbench.core.readers import kernels_per_tick as read  # noqa: F401
