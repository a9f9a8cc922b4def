"""Host read-backs a tick inside the closed loop's tick: the host calls
that wait for the card inside the port's ``loop.tick`` spans
(runtime/loop.py ClosedLoop.tick) on the traced window's thread, each
synchronise (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) and each copy whose device copy, found by its
correlation id, runs from the device to the host, over the window's
ticks. None where no card was traced or no such span ran."""
from mpcbench.core.launches import readbacks_inside


def read(ctx):
    return readbacks_inside(ctx, "loop.tick")
