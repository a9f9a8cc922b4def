"""Device ms a tick of the kernels launched inside the closed loop's plant
substeps: each host launch (``cudaLaunchKernel``, ``cuLaunch*``,
``cudaGraphLaunch``) that lies inside a port ``loop.plant`` span
(runtime/loop.py ClosedLoop.tick) on the traced window's thread, and the
device kernels that carry its correlation id (the profiler's
``FunctionEvent.id``), their time clipped to the window, over its ticks.
None where no card was traced or no such span ran."""
from mpcbench.core.launches import launched_inside


def read(ctx):
    return launched_inside(ctx, "loop.plant")
