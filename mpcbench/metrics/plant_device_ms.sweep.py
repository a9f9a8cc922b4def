"""Device ms a tick of the kernels launched inside the sweep's plant
substeps, every lane's: each host launch inside a port ``loop.plant`` span
(runtime/loop.py ClosedLoop.tick; a retry's too) on the traced window's
thread and the device kernels that carry its correlation id, clipped to the
window, over its ticks. None where no card was traced or no such span
ran."""
from mpcbench.core.launches import launched_inside


def read(ctx):
    return launched_inside(ctx, "loop.plant")
