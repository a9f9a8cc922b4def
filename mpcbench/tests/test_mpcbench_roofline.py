"""The kernels' roofline counts against the bound column of PERF.md §6 (the
tuned rows at B = 1, 64, 256 and 1024, P = 128, chip_smoke.py phase 2).

Where a row is bound by bytes, the count gives the table's bound. Where it
is bound by operations, the table counted one algorithm's own work: a
Gauss-Jordan inverse of the n x n capacitance (2 n^3 against an LU's
2 n^3 / 3), the full rank-n update (2 P^2 n against one triangle's P^2 n),
a symmetrisation (2 P^2) and both full products of a Newton-Schulz step
(4 P^3 against 3 P^3). The old count is kept here to show that it gives
the table, and that the new one differs from it by exactly those terms.
"""

import pytest

from mpcbench.core import spec

PEAKS = spec.peaks()


def bound_ms(ops, nbytes):
    t_ops = ops / PEAKS["fp32_flops_per_s"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def old_woodbury_ops(B, n, n_ns, P=128):
    return B * (2 * n ** 3 + 2 * n * n * P + 2 * P * P * n
                + n_ns * 4 * P ** 3 + 2 * P * P)


# (B, n_box, n_ns, the table's bound ms, bound by)
WOODBURY = [(256, 24, 1, 0.0359, "operations"),
            (64, 24, 1, 0.00896, "operations"),
            (1024, 24, 1, 0.1434, "operations"),
            (1024, 24, 0, 0.0404, "bytes"),
            (256, 24, 0, 0.0101, "bytes"),
            (64, 24, 0, 0.00252, "bytes"),
            (1, 24, 0, 0.0000394, "bytes"),
            (1, 24, 1, 0.000140, "operations"),
            (256, 120, 1, 0.0745, "operations"),
            (256, 120, 0, 0.0424, "operations")]
# (B, length, the table's bound ms), all bound by bytes
SEGMENT = [(256, 5, 0.00544), (64, 5, 0.00136), (1, 5, 0.0000212),
           (1024, 5, 0.0218)]


def call(B, P, **keywords):
    """A wrapper call's arguments as the traced run records them: K^-1
    [B, P, P] first, then a vector, then the keywords."""
    return dict(shapes=[(B, P, P), (B, P)], **keywords)


def close(a, b):
    """Equal to the table's three significant digits."""
    return abs(a - b) <= 0.006 * b


@pytest.mark.parametrize("B,length,table", SEGMENT)
def test_segment_count_gives_the_table(B, length, table):
    ops, nbytes = spec.roofline("admm_segment").work(
        call(B, 128, length=length))
    ms, by = bound_ms(ops, nbytes)
    assert by == "bytes" and close(ms, table)


@pytest.mark.parametrize("B,n,n_ns,table,by", WOODBURY)
def test_woodbury_count_against_the_table(B, n, n_ns, table, by):
    P = 128
    ops, nbytes = spec.roofline("woodbury_ns").work(
        call(B, P, n_box=n, n_ns=n_ns))
    old = old_woodbury_ops(B, n, n_ns)
    assert close(bound_ms(old, nbytes)[0], table)
    assert bound_ms(old, nbytes)[1] == by
    assert old - ops == pytest.approx(B * (4 * n ** 3 / 3 + P * P * n
                                           + 2 * P * P + n_ns * P ** 3))
    if by == "bytes":
        assert bound_ms(ops, nbytes) == (pytest.approx(bound_ms(old, nbytes)[0]),
                                         "bytes")
        assert close(bound_ms(ops, nbytes)[0], table)
    else:
        assert bound_ms(ops, nbytes)[0] < table


def test_count_does_not_depend_on_the_route():
    """The same shapes give the same count whatever the plan: the count
    takes no route, cluster or tile."""
    w = spec.roofline("woodbury_ns").work
    a = call(1, 256, n_box=132, n_ns=1)
    assert w(a) == w(dict(a, route="general", cluster=8, tile=32))
