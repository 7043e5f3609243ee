"""Row-wise Gustavson SpGEMM: the numpy CSR oracle of the numeric phase.

``spgemm_gustavson`` is vectorized row-wise Gustavson (paper Fig. 1):
C(i,:) = Σ_j A(i,j) · B(j,:), by expansion + sort + compression (the same
sort-merge semantics as the paper's hardware SM unit). End-to-end checks
hold the block-structural plan output against it.

``gustavson_flops`` is the paper's N_Ops: one multiply and one add per
(A-nonzero × matching B-row nonzero), i.e. ``2 · Σ_{A(i,j)≠0} nnz(B(j,:))``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.formats import CSR

__all__ = ["gustavson_flops", "spgemm_gustavson"]


def spgemm_gustavson(a: CSR, b: CSR) -> CSR:
    """Row-wise Gustavson's algorithm (paper Fig. 1), vectorized.

    For every nonzero A(i, j), expand the sparse partial-product row
    A(i, j) · B(j, :); then sort by (row, col) and merge equal columns —
    exactly the sort + merge of the paper's Sec. 2.2 description.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
    m, n = a.shape[0], b.shape[1]
    a_rows = np.repeat(np.arange(m, dtype=np.int64), a.row_nnz())
    # Products per A-nonzero = nnz of the matching B row.
    b_row_nnz = b.row_nnz()
    counts = b_row_nnz[a.indices]
    total = int(counts.sum())
    if total == 0:
        return CSR(np.zeros(m + 1, np.int64), np.zeros(0, np.int32), np.zeros(0, a.data.dtype), (m, n))
    # Expansion: for A-nonzero t with column j, emit B[indptr[j]:indptr[j+1]).
    starts = b.indptr[a.indices]
    seg = np.repeat(np.arange(a.nnz, dtype=np.int64), counts)
    # offset within each segment
    seg_starts = np.zeros(a.nnz + 1, dtype=np.int64)
    np.cumsum(counts, out=seg_starts[1:])
    within = np.arange(total, dtype=np.int64) - seg_starts[seg]
    b_pos = starts[seg] + within
    prod_row = a_rows[seg]
    prod_col = b.indices[b_pos].astype(np.int64)
    prod_val = a.data[seg] * b.data[b_pos]
    # Sort by (row, col) then merge runs with equal keys.
    order = np.lexsort((prod_col, prod_row))
    prod_row, prod_col, prod_val = prod_row[order], prod_col[order], prod_val[order]
    change = np.empty(total, dtype=bool)
    change[0] = True
    change[1:] = (prod_row[1:] != prod_row[:-1]) | (prod_col[1:] != prod_col[:-1])
    out_idx = np.cumsum(change) - 1
    out_nnz = int(out_idx[-1]) + 1
    out_val = np.zeros(out_nnz, dtype=prod_val.dtype)
    np.add.at(out_val, out_idx, prod_val)
    out_row = prod_row[change]
    out_col = prod_col[change].astype(np.int32)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, out_row + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(indptr, out_col, out_val, (m, n))


def gustavson_flops(a: CSR, b: CSR) -> int:
    """Paper's N_Ops: 2 FLOPs per expanded partial product (mul + add)."""
    return int(2 * b.row_nnz()[a.indices].sum())
