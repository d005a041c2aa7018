"""The benchmark's own count of the block-arrow factor's work, and the
peaks of one H100 SXM.

The count is of what the problem needs at its real block sizes (``nb``
interval blocks of ``ni`` interior unknowns, a reduced block of ``nr``), not
of the padded sizes a kernel chooses, so a share reads the same work
whatever implements it. One lane's factorization of the block-arrow matrix

    [A_1          B_1]
    [    ...      ...]
    [        A_nb B_nb]
    [B_1^T ... B_nb^T C]

is, per block, the Cholesky factor of A_k, X_k = A_k^{-1} B_k (a forward
and a back substitution of nr columns) and the Schur update of C by
B_k^T X_k (its lower triangle); then the Cholesky factor of the reduced
block. One attempt per block: no retry is counted. Bytes: the lower
triangles of each A_k and of C, each B_k and one shift per lane read once;
the lower triangles of each factor, each X_k and one flag per lane written
once. An operation is an add, a multiply, a divide or a square root.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth; float32 outside the
# tensor cores; float64 through the FP64 tensor cores (the scalar float64
# rate is 34e12)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def chol_ops(n: int) -> int:
    """Cholesky of an n x n matrix: for column j, the pivot's dot of j
    terms (2 j) and its square root, and for each of the n - 1 - j entries
    below it a dot of j terms, the subtraction and the division (2 j + 1)."""
    return sum(2 * j + 1 + (n - 1 - j) * (2 * j + 1) for j in range(n))


def factor_lane_ops(nb: int, ni: int, nr: int) -> int:
    tri = nr * (nr + 1) // 2
    per_block = chol_ops(ni) + 2 * nr * ni * ni + tri * 2 * ni
    return nb * per_block + chol_ops(nr)


def factor_lane_bytes(nb: int, ni: int, nr: int, itemsize: int) -> int:
    tri = lambda n: n * (n + 1) // 2
    read = nb * (tri(ni) + ni * nr) + tri(nr) + 1
    written = nb * (tri(ni) + ni * nr) + tri(nr) + 1
    return (read + written) * itemsize


def factor_bound_s(nb: int, ni: int, nr: int, lanes: int, dtype: str) -> dict:
    """The least time one factor launch on ``lanes`` lanes could take: the
    larger of its bytes over the memory rate and its operations over the
    peak rate of ``dtype``."""
    nbytes = lanes * factor_lane_bytes(nb, ni, nr, ITEMSIZE[dtype])
    ops = lanes * factor_lane_ops(nb, ni, nr)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return {"bytes": nbytes, "ops": ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
