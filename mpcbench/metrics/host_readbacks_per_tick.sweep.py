"""Host read-backs a sweep tick: the port's batch-wide decisions
(``qp.condensed.batch_any.syncs``: the solver's gates and the recovery
predicate, each one read-back) over the traced window's ticks."""
from mpcbench.core.readers import readbacks_per_tick as read  # noqa: F401
