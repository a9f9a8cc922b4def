"""Host ms a tick in the plant's jets (the LSTM step and the EKF update of
each substep): the port's ``plant.jets`` spans (sim/plant.py substep),
clipped to the traced window, over its ticks."""
from mpcbench.core.spans import host_ms_per_tick


def read(ctx):
    return host_ms_per_tick(ctx, "plant.jets")
