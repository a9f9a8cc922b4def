"""Share of the sweep's plant substeps replayed from a CUDA graph: the
port's ``sim.plant.run_substeps.graphed_substeps`` over its ``.substeps``
over the traced window, in per cent. None where the program keeps no such
counter or ran no substep."""


def read(ctx):
    c = ctx["counters"]
    n = c.get("sim.plant.run_substeps.substeps")
    graphed = c.get("sim.plant.run_substeps.graphed_substeps")
    if not n or graphed is None:
        return None
    return 100.0 * graphed / n
