"""admm_segment's share of its roofline, in per cent: the least time its calls in
the traced window could take (mpcbench/roofline/admm_segment.py) over its
kernels' device time."""
from mpcbench.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "admm_segment")
