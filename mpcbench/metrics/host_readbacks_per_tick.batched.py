"""Host read-backs a tick: the port's batch-wide decisions
(qp/condensed.py batch_any.syncs) over the traced window's ticks."""
from mpcbench.core.readers import readbacks_per_tick as read  # noqa: F401
