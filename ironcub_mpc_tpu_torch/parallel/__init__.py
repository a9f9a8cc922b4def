"""Scenario-parallel Monte-Carlo sweeps over ``torch.distributed`` process
meshes. ``pipeline_tick`` (``pp_pipeline.py``) and ``solve_tp``
(``tp_admm.py``) of the JAX package are not ported yet."""

from .mesh import Mesh, make_mesh, multihost_init, scenario_shard  # noqa: F401
from .monte_carlo import (  # noqa: F401
    STATUS_COLS,
    ScenarioConfig,
    SweepResult,
    make_batched_carry,
    recovery_settings,
    run_sweep,
)
