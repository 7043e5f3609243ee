"""Row-wise Gustavson SpGEMM + the paper's comparison algorithms.

Three layers, all equal in result, pure numpy and equal bit for bit to the
JAX package's ``core/gustavson.py``:

1. ``spgemm_gustavson`` — vectorized row-wise Gustavson (paper Fig. 1):
   C(i,:) = Σ_j A(i,j) · B(j,:), by expansion + sort + compression (the
   same sort-merge semantics as the paper's hardware SM unit). The numpy
   CSR oracle of the numeric phase: end-to-end checks hold the
   block-structural plan output against it.
2. ``FSpGEMMSimulator`` — a functional + performance simulator of the
   paper's FPGA kernel (Sec. 4.2): NUM_PE PEs consuming the CSV stream, a
   shared B-row buffer (Sec. 4.1), SW-wide VecMult, and the
   double-buffered Sort-Merge unit of Algorithm 1. It counts cycles, B-row
   fetches and off-chip traffic, which feed the STUF/runtime/energy models
   (Tables 7-9) and validate OMAR (Eq. 1) against an actual fetch trace.
3. ``spgemm_inner`` / ``spgemm_outer`` — the inner-product and
   outer-product baselines (Sec. 2.2) with their overheads surfaced as
   statistics (index-matching comparisons, zero-output work,
   partial-matrix traffic).

``gustavson_flops`` is the paper's N_Ops: one multiply and one add per
(A-nonzero × matching B-row nonzero), i.e. ``2 · Σ_{A(i,j)≠0} nnz(B(j,:))``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.sparse.formats import COO, CSC, CSR, CSV

__all__ = [
    "spgemm_gustavson",
    "spgemm_inner",
    "spgemm_outer",
    "gustavson_flops",
    "SpGEMMStats",
    "FSpGEMMSimulator",
]


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


# ---------------------------------------------------------------------------
# Baseline algorithms (paper Sec. 2.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpGEMMStats:
    """Operation statistics used by the performance models."""

    flops: int = 0  # useful multiply+add FLOPs
    index_match_ops: int = 0  # inner product's comparison overhead
    zero_outputs: int = 0  # inner product's wasted dot products
    partial_nnz: int = 0  # outer product's partial-matrix traffic (elements)
    b_row_fetches: int = 0  # Gustavson off-chip B-row fetches
    b_elements_fetched: int = 0
    cycles: int = 0  # simulator only


def spgemm_inner(a: CSR, b_csc: CSC) -> Tuple[CSR, SpGEMMStats]:
    """Inner-product SpGEMM (paper Sec. 2.2): computes *every* C(i, j) by a
    sorted index-matching dot product — including the zero outputs that
    Gustavson never touches. Returns the result plus overhead statistics.

    Only suitable for small/scaled matrices (it inspects all M·N pairs at
    row-column granularity, as the algorithm semantically must).
    """
    m, n = a.shape[0], b_csc.shape[1]
    out_rows, out_cols, out_vals = [], [], []
    stats = SpGEMMStats()
    for i in range(m):
        a_cols, a_vals = a.row_slice(i)
        if a_cols.shape[0] == 0:
            # Still "computes" the whole empty row in the inner-product model.
            stats.zero_outputs += n
            continue
        for j in range(n):
            b_rows, b_vals = b_csc.col_slice(j)
            # merge-style index matching (two-pointer; each comparison is
            # the hardware-expensive op identified by Jamro et al.)
            p = q = 0
            acc = 0.0
            matched = 0
            while p < a_cols.shape[0] and q < b_rows.shape[0]:
                stats.index_match_ops += 1
                if a_cols[p] == b_rows[q]:
                    acc += float(a_vals[p]) * float(b_vals[q])
                    matched += 1
                    p += 1
                    q += 1
                elif a_cols[p] < b_rows[q]:
                    p += 1
                else:
                    q += 1
            stats.flops += 2 * matched
            if matched and acc != 0.0:
                out_rows.append(i)
                out_cols.append(j)
                out_vals.append(acc)
            else:
                stats.zero_outputs += 1
    coo = COO(
        np.asarray(out_rows, np.int32),
        np.asarray(out_cols, np.int32),
        np.asarray(out_vals, a.data.dtype),
        (m, n),
    )
    return CSR.from_coo(coo), stats


def spgemm_outer(a_csc: CSC, b: CSR) -> Tuple[CSR, SpGEMMStats]:
    """Outer-product SpGEMM (paper Sec. 2.2): Σ_k outer(A(:,k), B(k,:)).

    Each outer product emits a partial matrix; the total partial-element
    count models the off-chip buffering traffic the paper criticizes.
    """
    if a_csc.shape[1] != b.shape[0]:
        raise ValueError("inner dims mismatch")
    m, n = a_csc.shape[0], b.shape[1]
    stats = SpGEMMStats()
    rows_l, cols_l, vals_l = [], [], []
    for k in range(a_csc.shape[1]):
        a_rows, a_vals = a_csc.col_slice(k)
        b_cols, b_vals = b.row_slice(k)
        if a_rows.shape[0] == 0 or b_cols.shape[0] == 0:
            continue
        rr = np.repeat(a_rows, b_cols.shape[0])
        cc = np.tile(b_cols, a_rows.shape[0])
        vv = np.outer(a_vals, b_vals).ravel()
        stats.flops += 2 * vv.shape[0]
        stats.partial_nnz += vv.shape[0]
        rows_l.append(rr)
        cols_l.append(cc)
        vals_l.append(vv)
    if rows_l:
        coo = COO(
            np.concatenate(rows_l),
            np.concatenate(cols_l),
            np.concatenate(vals_l).astype(a_csc.data.dtype),
            (m, n),
        ).sum_duplicates()
    else:
        coo = COO(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, a_csc.data.dtype), (m, n))
    return CSR.from_coo(coo), stats


# ---------------------------------------------------------------------------
# Faithful FPGA-kernel simulator (Sec. 4.2 + Algorithm 1)
# ---------------------------------------------------------------------------

class _SortMergeUnit:
    """One PE's Sort-Merge unit + double-buffered memory (Algorithm 1).

    Holds C_TEMP_ROW as two (VAL, COL_IND) buffers. ``merge`` combines the
    incoming sorted partial-product vector C_TEMP_VEC with the active buffer
    into the other buffer, counting comparison/merge cycles.
    """

    def __init__(self):
        self.buffers = [([], []), ([], [])]  # (cols, vals) per buffer
        self.sel = 0

    def reset(self):
        self.buffers = [([], []), ([], [])]
        self.sel = 0

    def merge(self, vec_cols: np.ndarray, vec_vals: np.ndarray) -> int:
        """Merge one sorted C_TEMP_VEC into C_TEMP_ROW. Returns cycles."""
        s = self.sel
        cols, vals = self.buffers[s]
        out_cols: list = []
        out_vals: list = []
        head, tail = 0, len(cols)
        ptr, sw = 0, len(vec_cols)
        cycles = 0
        # Algorithm 1: two-pointer sorted merge, one element per cycle.
        while ptr < sw:
            cycles += 1
            if head < tail:
                if cols[head] < vec_cols[ptr]:
                    out_cols.append(cols[head])
                    out_vals.append(vals[head])
                    head += 1
                elif cols[head] == vec_cols[ptr]:
                    out_cols.append(cols[head])
                    out_vals.append(vals[head] + vec_vals[ptr])
                    head += 1
                    ptr += 1
                else:
                    out_cols.append(int(vec_cols[ptr]))
                    out_vals.append(float(vec_vals[ptr]))
                    ptr += 1
            else:
                out_cols.append(int(vec_cols[ptr]))
                out_vals.append(float(vec_vals[ptr]))
                ptr += 1
        # Drain remaining buffered elements (paper: "no comparison needed").
        while head < tail:
            cycles += 1
            out_cols.append(cols[head])
            out_vals.append(vals[head])
            head += 1
        self.buffers[1 - s] = (out_cols, out_vals)
        self.sel = 1 - s
        return cycles

    def row(self) -> Tuple[np.ndarray, np.ndarray]:
        cols, vals = self.buffers[self.sel]
        return np.asarray(cols, np.int64), np.asarray(vals, np.float64)


class FSpGEMMSimulator:
    """Functional + performance simulator of the FSpGEMM FPGA kernel.

    Consumes the first input matrix in CSV format (paper Sec. 3) and the
    second in CSR (Sec. 4.2.2), processes CSV vectors with ``num_pe``
    parallel PEs sharing each fetched B row (Sec. 4.1), performs SW-wide
    VecMult + SM merges, and tracks:

      * ``b_row_fetches`` / ``b_elements_fetched`` — off-chip traffic to B
        (one fetch per CSV vector; OMAR's denominator counts one per
        A-nonzero in the naive scheme).
      * ``cycles`` — max over PEs per vector of VecMult/SM pipeline cycles
        (PEs run in parallel; the load kernel streams one CSV vector at a
        time), plus B streaming cycles at SW elements/cycle.
      * result correctness — bit-comparable to ``spgemm_gustavson``.
    """

    def __init__(self, num_pe: int, sw: int):
        if num_pe < 1 or sw < 1:
            raise ValueError("num_pe and sw must be >= 1")
        self.num_pe = num_pe
        self.sw = sw

    def run(self, a_csv: CSV, b: CSR) -> Tuple[CSR, SpGEMMStats]:
        if a_csv.num_pe != self.num_pe:
            raise ValueError("CSV group size != simulator NUM_PE")
        m, n = a_csv.shape[0], b.shape[1]
        stats = SpGEMMStats()
        sms = [_SortMergeUnit() for _ in range(self.num_pe)]
        out_rows: list = []
        out_cols: list = []
        out_vals: list = []

        # Iterate the CSV stream vector-by-vector (load kernel, Sec. 4.2.2):
        # a vector = run of consecutive entries with equal (group, col).
        vid = a_csv.vector_id()
        nnz = a_csv.nnz
        # Precompute the last nonzero position per row (RESET signal).
        last_of_row: Dict[int, int] = {}
        for t in range(nnz):
            last_of_row[int(a_csv.row_ind[t])] = t
        group = a_csv.group_of()
        t = 0
        while t < nnz:
            v = vid[t]
            t_end = t
            while t_end < nnz and vid[t_end] == v:
                t_end += 1
            j = int(a_csv.col_ind[t])
            b_cols, b_vals = b.row_slice(j)
            b_nnz = b_cols.shape[0]
            # One off-chip fetch of B(j,:) shared by all PEs of this vector.
            stats.b_row_fetches += 1
            stats.b_elements_fetched += int(b_nnz)
            n_b_vec = max(1, -(-b_nnz // self.sw))  # B_NUM_VEC (ceil)
            vec_cycles = n_b_vec  # streaming B at SW elems/cycle
            for tt in range(t, t_end):
                i = int(a_csv.row_ind[tt])
                pe = i % self.num_pe
                a_val = float(a_csv.val[tt])
                stats.flops += 2 * int(b_nnz)
                # VecMult: SW multiplies per cycle (n_b_vec cycles) feeding SM.
                prod_vals = a_val * b_vals.astype(np.float64)
                sm_cycles = sms[pe].merge(b_cols.astype(np.int64), prod_vals)
                vec_cycles = max(vec_cycles, sm_cycles)
                if tt == last_of_row[i]:
                    # RESET: drain this PE's row to the store kernel.
                    cols_i, vals_i = sms[pe].row()
                    keep = vals_i != 0.0
                    out_rows.extend([i] * int(keep.sum()))
                    out_cols.extend(cols_i[keep].tolist())
                    out_vals.extend(vals_i[keep].tolist())
                    sms[pe].reset()
            stats.cycles += vec_cycles
            t = t_end
        coo = COO(
            np.asarray(out_rows, np.int32),
            np.asarray(out_cols, np.int32),
            np.asarray(out_vals, np.float64).astype(a_csv.val.dtype),
            (m, n),
        )
        return CSR.from_coo(coo), stats
