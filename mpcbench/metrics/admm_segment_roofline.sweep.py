"""The sweep's ``admm_segment`` calls at its lanes under the flight's
solver as a share of their roofline: the least time of the calls over the
kernels' device time, in per cent (``core/readers.py``
``roofline_share``)."""
from mpcbench.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "admm_segment")
