"""Operations and bytes one ``woodbury_ns`` call needs: (K(rho_new))^-1
from (K(rho_old))^-1 on each of B lanes, padded to P, where rho moved on
n = n_box coordinates, then ``n_ns`` Newton-Schulz steps against K(rho_new).

The refresh is the rank-n Woodbury update. What it needs, whatever
algorithm a kernel runs:

- the n x n capacitance system I + diag(d) K^-1[box, box] factorised once,
  2 n^3 / 3 (an LU; a Gauss-Jordan inverse, 2 n^3, is one algorithm's own
  work);
- its solve for the n x P right-hand sides d * K^-1[box, :], 2 n^2 P;
- the symmetric rank-n update K^-1 - K^-1[:, box] X, one triangle,
  P^2 n (the full square, 2 P^2 n, and a symmetrisation, 2 P^2, are one
  algorithm's own work);
- each Newton-Schulz step X (2 I - K X): K X, 2 P^3, then the symmetric
  product X (K X) on one triangle, P^3.

The bytes are K^-1 read and the result written, d and rho read, and H read
only where a Newton-Schulz step needs K. The count depends on the shapes
alone, not on the route (tuned or general) that runs the call.
"""

KERNEL_NAMES = ("woodbury_ns_",)


def work(call):
    """``call``: the wrapper's arguments (K^-1 [B, P, P] first)."""
    B, P = call["shapes"][0][0], call["shapes"][0][-1]
    n, n_ns = call["n_box"], call["n_ns"]
    ops = B * (2 * n ** 3 / 3 + 2 * n * n * P + P * P * n
               + n_ns * 3 * P ** 3)
    nbytes = 4 * B * ((3 if n_ns else 2) * P * P + 2 * P)
    return ops, nbytes
