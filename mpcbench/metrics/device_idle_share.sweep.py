"""Share of the traced window, in per cent, in which no operation ran on
the card: 1 - (union of device intervals / window)."""
from mpcbench.core.readers import idle_share as read  # noqa: F401
