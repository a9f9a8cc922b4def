"""The parallel axes over ``torch.distributed`` process meshes: scenario-
parallel Monte-Carlo sweeps (``monte_carlo.py``), the row-sharded ADMM of
one QP over the kkt axis (``tp_admm.py``), the four-stage pipelined tick
(``pp_pipeline.py``) and the multi-process dry run of all three
(``dryrun.py``)."""

from .mesh import (Mesh, make_mesh, multihost_init, pick_backend,  # noqa: F401
                   scenario_shard)
from .pp_pipeline import N_STAGES, pipeline_tick  # noqa: F401
from .monte_carlo import (  # noqa: F401
    STATUS_COLS,
    ScenarioConfig,
    SweepResult,
    make_batched_carry,
    recovery_settings,
    run_sweep,
)
