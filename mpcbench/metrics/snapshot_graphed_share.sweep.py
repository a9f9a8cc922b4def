"""Share of the sweep's snapshots replayed from a CUDA graph: the port's
``runtime.loop.run_snapshot.graphed_snapshots`` over its ``.snapshots``
over the traced window, in per cent. None where the program keeps no such
counter or took no snapshot."""


def read(ctx):
    c = ctx["counters"]
    n = c.get("runtime.loop.run_snapshot.snapshots")
    graphed = c.get("runtime.loop.run_snapshot.graphed_snapshots")
    if not n or graphed is None:
        return None
    return 100.0 * graphed / n
