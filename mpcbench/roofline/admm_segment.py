"""Operations and bytes one ``admm_segment`` call needs: ``length`` ADMM
iterations on each of B lanes of a box QP padded to P, with (K(rho))^-1
given.

Each iteration needs the mat-vec x~ = K^-1 rhs, 2 P^2 operations, and about
12 element-wise operations a coordinate (rhs, relaxation, projection, dual
update). The bytes are K^-1 read once and the eight vectors in and three
out, each once: however a kernel schedules the iterations, it reads no
input twice by need. The count depends on the shapes alone, not on the
route (registers, cluster or spread) that runs the call.
"""

KERNEL_NAMES = ("admm_segment_",)


def work(call):
    """``call``: the wrapper's arguments (K^-1 [B, P, P] first)."""
    B, P, L = call["shapes"][0][0], call["shapes"][0][-1], call["length"]
    ops = B * L * (2 * P * P + 12 * P)
    nbytes = 4 * (B * P * P + 8 * B * P + 3 * B * P)
    return ops, nbytes
