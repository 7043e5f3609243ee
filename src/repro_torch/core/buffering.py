"""The paper's data buffering scheme and its OMAR metric (Sec. 4.1, Eq. 1).

``omar`` implements Eq. 1 exactly:

    OMAR(%) = Σ_{v ∈ V} (nnz(A(v)) − 1) / nnz(A) × 100

where a CSV vector ``v`` is the set of nonzeros of A sharing one column
inside one NUM_PE-row group — all of which share a single fetched row of B.

``b_fetch_trace``/``omar_from_trace`` re-derive the same number from an
actual fetch trace (each CSV vector triggers exactly one B-row fetch), which
is the property the FPGA buffer enforces; the block-Gustavson schedule
reproduces it at tile granularity by fetching each B block row once per
run of A tiles that share it.

``block_omar`` is the BCSV tile-granularity analogue. Pure numpy, equal
to the JAX package's ``core/buffering.py`` bit for bit.
"""
from __future__ import annotations

from typing import Union

import numpy as np

from repro_torch.sparse.convert import to_csv
from repro_torch.sparse.formats import BCSV, CSR, CSV

__all__ = [
    "omar",
    "omar_from_trace",
    "b_fetch_trace",
    "block_omar",
    "block_b_fetch_trace",
]


def omar(a: Union[CSR, CSV, np.ndarray], num_pe: int) -> float:
    """Off-chip memory access reduction percentage (paper Eq. 1)."""
    csv = a if isinstance(a, CSV) and a.num_pe == num_pe else to_csv(a, num_pe)
    nnz = csv.nnz
    if nnz == 0:
        return 0.0
    vid = csv.vector_id()
    num_vectors = int(vid[-1]) + 1
    # Σ_v (nnz(A(v)) − 1)  ==  nnz(A) − #vectors
    saved = nnz - num_vectors
    return 100.0 * saved / nnz


def b_fetch_trace(a: Union[CSR, CSV, np.ndarray], num_pe: int) -> np.ndarray:
    """Sequence of B-row indices fetched from off-chip memory when the
    buffering scheme of Sec. 4.1 processes A in CSV order.

    One fetch per CSV vector (the buffered row is shared by all PEs); the
    naive Gustavson scheme fetches once per A-nonzero instead.
    """
    csv = a if isinstance(a, CSV) and a.num_pe == num_pe else to_csv(a, num_pe)
    if csv.nnz == 0:
        return np.zeros(0, dtype=np.int64)
    vid = csv.vector_id()
    first_of_vector = np.empty(csv.nnz, dtype=bool)
    first_of_vector[0] = True
    first_of_vector[1:] = vid[1:] != vid[:-1]
    return csv.col_ind[first_of_vector].astype(np.int64)


def omar_from_trace(a: Union[CSR, CSV, np.ndarray], num_pe: int) -> float:
    """OMAR re-derived from the actual fetch trace (must equal Eq. 1)."""
    csv = a if isinstance(a, CSV) and a.num_pe == num_pe else to_csv(a, num_pe)
    nnz = csv.nnz
    if nnz == 0:
        return 0.0
    fetches = b_fetch_trace(csv, num_pe).shape[0]
    return 100.0 * (nnz - fetches) / nnz


def block_omar(a: BCSV) -> float:
    """Tile-granularity OMAR for the BCSV path.

    A fetched B block-row is reused by consecutive A tiles sharing ``bcol``
    inside one block-row group: the copy is elided whenever the B-operand
    block index is unchanged between consecutive tiles in BCSV order.
    """
    if a.nnzb == 0:
        return 0.0
    g = a.group_of().astype(np.int64)
    c = a.bcol.astype(np.int64)
    change = np.empty(a.nnzb, dtype=bool)
    change[0] = True
    change[1:] = (g[1:] != g[:-1]) | (c[1:] != c[:-1])
    fetches = int(change.sum())
    return 100.0 * (a.nnzb - fetches) / a.nnzb


def block_b_fetch_trace(a: BCSV) -> np.ndarray:
    """B block-row ids fetched in kernel grid order (copy-elision model)."""
    if a.nnzb == 0:
        return np.zeros(0, dtype=np.int64)
    g = a.group_of().astype(np.int64)
    c = a.bcol.astype(np.int64)
    change = np.empty(a.nnzb, dtype=bool)
    change[0] = True
    change[1:] = (g[1:] != g[:-1]) | (c[1:] != c[:-1])
    return c[change]
