"""The yardstick of a product's work: its element-level operations and bytes,
and the table of the card's peaks that turns them into a least time.

The count is of C = A·B itself, whatever implements it: 2 operations for
each pair of stored entries ``A[i,k]``, ``B[k,j]``; A's and B's values and
column indices read once, and the exact C's values and column indices
written once (float32 values, int32 indices). A change of tile, schedule
or algorithm in the program does not change it.
"""
from __future__ import annotations

import numpy as np

# Published peaks, NVIDIA's data sheet for the H100 SXM (dense, no
# sparsity), at the full power limit of 700 W.
PEAKS = {
    "H100": {"float32_flops_per_s": 67e12, "bytes_per_s": 3.35e12},
}
VALUE_BYTES = 4
INDEX_BYTES = 4


def peak(device_name: str):
    """The peaks of the card named ``device_name``, or ``None`` for a card
    the table does not hold."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    return None


def product_flops(a, b) -> int:
    """2 · Σ_k nnz(A[:, k]) · nnz(B[k, :])."""
    k = a.shape[1]
    col_a = np.bincount(a.col, minlength=k).astype(np.int64)
    row_b = np.bincount(b.row, minlength=k).astype(np.int64)
    return int(2 * np.dot(col_a, row_b))


def product_bytes(nnz_a: int, nnz_b: int, nnz_c: int) -> int:
    """Inputs' values and column indices read once, the exact output's
    written once."""
    return (nnz_a + nnz_b + nnz_c) * (VALUE_BYTES + INDEX_BYTES)


def least_seconds(flops: int, nbytes: int, peaks: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / peaks["float32_flops_per_s"], nbytes / peaks["bytes_per_s"])
