from . import blocks  # noqa: F401
from . import assembly  # noqa: F401
from .mpc import (  # noqa: F401
    MPCProblem,
    configure,
    mpc_tick,
)
