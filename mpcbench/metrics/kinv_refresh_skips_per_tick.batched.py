"""Ticks whose batch-wide K⁻¹ refresh was skipped (every lane's probe inside
``ns_skip_tol``, K⁻¹ carried untouched), a tick: the port's
``qp.condensed.solve.refresh_skips`` over the traced window's ticks."""


def read(ctx):
    n = ctx["counters"].get("qp.condensed.solve.refresh_skips")
    return None if n is None else n / ctx["ticks"]
