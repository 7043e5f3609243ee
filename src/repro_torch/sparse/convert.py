"""Format conversions (the paper's host pre-processing utilities, Sec. 4.3).

The paper: "the utility functions read in the raw matrix files in an
existing sparse matrix format then convert and store the matrices in the
CSV format. The pre-processing step only needs to be performed once."
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.sparse.formats import BCSR, BCSV, COO, CSC, CSR, CSV

AnySparse = Union[COO, CSR, CSC, CSV, BCSR, BCSV]


def to_coo(a: Union[np.ndarray, torch.Tensor, AnySparse]) -> COO:
    """Any input as COO. A torch tensor (strided, sparse COO or sparse CSR,
    on any device) gives its nonzeros with numpy values; bfloat16 values,
    which numpy has no type for, are widened exactly to float32 (a sparse
    COO tensor's duplicates are summed in its own dtype first)."""
    if isinstance(a, torch.Tensor):
        return _tensor_to_coo(a)
    if isinstance(a, np.ndarray):
        return COO.fromdense(a)
    if isinstance(a, COO):
        return a
    if isinstance(a, (CSR, CSC, CSV, BCSR, BCSV)):
        return a.to_coo()
    raise TypeError(f"cannot convert {type(a)} to COO")


def _tensor_to_coo(t: torch.Tensor) -> COO:
    if t.dim() != 2:
        raise ValueError(f"expected a 2-D tensor, got shape {tuple(t.shape)}")
    t = t.detach().cpu().to_sparse_coo().coalesce()
    val = t.values()
    if val.dtype == torch.bfloat16:
        val = val.float()
    idx = t.indices().numpy()
    return COO(idx[0], idx[1], val.numpy(), tuple(int(d) for d in t.shape))


def to_csr(a: Union[np.ndarray, AnySparse]) -> CSR:
    if isinstance(a, CSR):
        return a
    return CSR.from_coo(to_coo(a).sum_duplicates())


def to_csc(a: Union[np.ndarray, AnySparse]) -> CSC:
    if isinstance(a, CSC):
        return a
    return _coo_to_csc(to_coo(a).sum_duplicates())


def _coo_to_csc(coo: COO) -> CSC:
    order = np.lexsort((coo.row, coo.col))
    r, c, v = coo.row[order], coo.col[order], coo.val[order]
    indptr = np.zeros(coo.shape[1] + 1, dtype=np.int64)
    np.add.at(indptr, c.astype(np.int64) + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSC(indptr, r, v, coo.shape)


def to_csv(a: Union[np.ndarray, AnySparse], num_pe: int) -> CSV:
    """Convert to the paper's CSV format with ``num_pe`` rows per group."""
    if isinstance(a, CSV) and a.num_pe == num_pe:
        return a
    return CSV.from_coo(to_coo(a).sum_duplicates(), num_pe)


def _block_coords(
    coo: COO, block_shape: Tuple[int, int]
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Per-nonzero block keys for a *deduplicated* COO, plus the padded grid.

    Returns ``(bid, (gm, gk))`` where ``bid = brow * gk + bcol`` is a single
    sortable block key (callers recover ``brow``/``bcol`` of the *unique*
    blocks via ``divmod(bid, gk)``). The grid covers ceil-divided (padded)
    dims, so no dense padding is ever materialized.
    """
    bm, bk = block_shape
    m, k = coo.shape
    gm, gk = -(-m // bm), -(-k // bk)
    brow = (coo.row // bm).astype(np.int64)
    bcol = (coo.col // bk).astype(np.int64)
    return brow * gk + bcol, (gm, gk)


def bcsr_from_coo(
    coo: COO, block_shape: Tuple[int, int]
) -> Tuple[BCSR, np.ndarray]:
    """Sparse-native COO -> BCSR: O(nnz log nnz), never densifies.

    ``coo`` must have unique coordinates (``sum_duplicates`` first).
    Returns the BCSR plus ``scatter``: flat indices into ``blocks`` such
    that ``blocks.reshape(-1)[scatter] = coo.val`` re-materializes the
    packed value array from a fresh value vector in ``coo`` order — the
    numeric-phase rebind used by SpGEMMPlan.execute.
    """
    bm, bk = block_shape
    bid, (gm, gk) = _block_coords(coo, block_shape)
    ub = np.unique(bid)  # ascending == (brow, bcol) block-row-major
    slot = np.searchsorted(ub, bid)
    scatter = slot * (bm * bk) + (coo.row % bm).astype(np.int64) * bk + (
        coo.col % bk
    ).astype(np.int64)
    blocks = np.zeros((ub.shape[0], bm, bk), coo.val.dtype)
    blocks.reshape(-1)[scatter] = coo.val
    ubr, ubc = ub // gk, ub % gk
    indptr = np.zeros(gm + 1, dtype=np.int64)
    np.add.at(indptr, ubr + 1, 1)
    np.cumsum(indptr, out=indptr)
    return (
        BCSR(indptr, ubc.astype(np.int32), blocks, (gm * bm, gk * bk)),
        scatter,
    )


def bcsv_from_coo(
    coo: COO, block_shape: Tuple[int, int], group: int
) -> Tuple[BCSV, np.ndarray]:
    """Sparse-native COO -> BCSV (vector-major block order), never densifies.

    Same contract as :func:`bcsr_from_coo`: unique coordinates in, format
    plus flat ``scatter`` indices out.
    """
    bm, bk = block_shape
    bid, (gm, gk) = _block_coords(coo, block_shape)
    ub = np.unique(bid)
    ubr, ubc = ub // gk, ub % gk
    # Vector-major order: (block-row group, bcol, brow).
    order = np.lexsort((ubr, ubc, ubr // group))
    rank = np.empty(ub.shape[0], np.int64)
    rank[order] = np.arange(ub.shape[0])
    slot = rank[np.searchsorted(ub, bid)]
    scatter = slot * (bm * bk) + (coo.row % bm).astype(np.int64) * bk + (
        coo.col % bk
    ).astype(np.int64)
    blocks = np.zeros((ub.shape[0], bm, bk), coo.val.dtype)
    blocks.reshape(-1)[scatter] = coo.val
    sbr, sbc = ubr[order], ubc[order]
    n_groups = -(-gm // group)
    group_ptr = np.zeros(n_groups + 1, dtype=np.int64)
    np.add.at(group_ptr, (sbr // group) + 1, 1)
    np.cumsum(group_ptr, out=group_ptr)
    return (
        BCSV(
            blocks,
            sbr.astype(np.int32),
            sbc.astype(np.int32),
            group_ptr,
            (gm * bm, gk * bk),
            group,
        ),
        scatter,
    )


def to_bcsr(
    a: Union[np.ndarray, AnySparse], block_shape: Tuple[int, int]
) -> BCSR:
    if isinstance(a, BCSR) and a.block_shape == tuple(block_shape):
        return a
    bcsr, _ = bcsr_from_coo(to_coo(a).sum_duplicates(), block_shape)
    return bcsr


def to_bcsv(
    a: Union[np.ndarray, AnySparse], block_shape: Tuple[int, int], group: int
) -> BCSV:
    if (
        isinstance(a, BCSV)
        and a.block_shape == tuple(block_shape)
        and a.group == group
    ):
        return a
    bcsv, _ = bcsv_from_coo(to_coo(a).sum_duplicates(), block_shape, group)
    return bcsv


def pad_to_blocks(a: np.ndarray, block_shape: Tuple[int, int]) -> np.ndarray:
    """Zero-pad a dense matrix so both dims divide the block shape."""
    bm, bn = block_shape
    m, n = a.shape
    pm, pn = (-m) % bm, (-n) % bn
    if pm == 0 and pn == 0:
        return a
    return np.pad(a, ((0, pm), (0, pn)))


def csr_to_csv(a: CSR, num_pe: int) -> CSV:
    """Direct CSR -> CSV conversion (the paper's primary preprocessing path)."""
    return CSV.from_coo(a.to_coo(), num_pe)


def csv_to_csr(a: CSV) -> CSR:
    return CSR.from_coo(a.to_coo())
