"""woodbury_ns's share of its roofline, in per cent: the least time its calls in
the traced window could take (mpcbench/roofline/woodbury_ns.py) over its
kernels' device time."""
from mpcbench.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "woodbury_ns")
