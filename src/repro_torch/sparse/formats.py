"""Sparse matrix container formats.

Paper mapping (FSpGEMM Sec. 2.1 and Sec. 3):

* ``COO`` / ``CSR`` / ``CSC`` — the standard formats the paper builds on.
* ``CSV`` — the paper's Compressed Sparse Vector format: nonzeros stored in
  *vector-major* order. Rows are partitioned into groups of ``num_pe`` rows
  (one row per computing unit); within each group nonzeros are sorted by
  ``(col, row)``. Each nonzero carries ``(VAL, ROW_IND, COL_IND)`` so the
  reader never needs a per-row lookup table (Sec. 3). Consecutive nonzeros
  sharing a column inside one group form a "CSV vector" — they share a
  single fetch of the corresponding row of the second input matrix
  (the buffering scheme of Sec. 4.1, measured by OMAR, Eq. 1).
* ``BCSR`` / ``BCSV`` — block variants of the same layouts at tile
  granularity, consumed by the block-Gustavson kernel. ``BCSV`` orders
  nonzero (bm, bk) blocks by ``(brow // group, bcol, brow)``, so the
  packed value array is read in one sequential stream and blocks sharing
  a B block-row sit next to each other (the tile analogue of the paper's
  B-row buffer).

All containers are host-side ``numpy`` structures (the paper's host program
owns format conversion; Sec. 4.3). Kernels receive plain arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["SparseFormat", "COO", "CSR", "CSC", "CSV", "BCSR", "BCSV"]


def _as1d(a, dtype=None) -> np.ndarray:
    out = np.asarray(a)
    if dtype is not None:
        out = out.astype(dtype, copy=False)
    return np.ascontiguousarray(out)


class SparseFormat:
    """Base class: every format knows its dense shape and nnz."""

    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        raise NotImplementedError

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m and n else 0.0

    def todense(self) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        m, n = self.shape
        return (
            f"{type(self).__name__}(shape=({m}, {n}), nnz={self.nnz}, "
            f"density={self.density:.2e})"
        )


@dataclasses.dataclass(repr=False)
class COO(SparseFormat):
    """Coordinate format. Canonical order is row-major ``(row, col)``."""

    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        self.row = _as1d(self.row, np.int32)
        self.col = _as1d(self.col, np.int32)
        self.val = _as1d(self.val)
        if not (self.row.shape == self.col.shape == self.val.shape):
            raise ValueError("COO arrays must have identical 1-D shapes")

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def sort_rowmajor(self) -> "COO":
        order = np.lexsort((self.col, self.row))
        return COO(self.row[order], self.col[order], self.val[order], self.shape)

    def sum_duplicates(self) -> "COO":
        """Merge duplicate coordinates (paper: the 'merge' half of sort-merge)."""
        if self.nnz == 0:
            return self
        order = np.lexsort((self.col, self.row))
        r, c, v = self.row[order], self.col[order], self.val[order]
        key_change = np.empty(r.shape[0], dtype=bool)
        key_change[0] = True
        key_change[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        idx = np.cumsum(key_change) - 1
        out_v = np.zeros(int(idx[-1]) + 1, dtype=v.dtype)
        np.add.at(out_v, idx, v)
        return COO(r[key_change], c[key_change], out_v, self.shape)

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.val.dtype)
        np.add.at(out, (self.row, self.col), self.val)
        return out

    @staticmethod
    def fromdense(a: np.ndarray) -> "COO":
        a = np.asarray(a)
        r, c = np.nonzero(a)
        return COO(r.astype(np.int32), c.astype(np.int32), a[r, c], a.shape)


@dataclasses.dataclass(repr=False)
class CSR(SparseFormat):
    """Compressed Sparse Row (paper Fig. 2, row-major order).

    ``V = data``, ``COL_INDEX = indices``, ``ROW_PTR = indptr``.
    FSpGEMM stores the *second* input matrix in CSR so a full row can be
    streamed contiguously (Sec. 4.2.2).
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        self.indptr = _as1d(self.indptr, np.int64)
        self.indices = _as1d(self.indices, np.int32)
        self.data = _as1d(self.data)
        if self.indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(
                f"indptr length {self.indptr.shape[0]} != rows+1 ({self.shape[0] + 1})"
            )

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def row_slice(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), self.row_nnz())
        out[rows, self.indices] = self.data
        return out

    @staticmethod
    def fromdense(a: np.ndarray) -> "CSR":
        return CSR.from_coo(COO.fromdense(a))

    @staticmethod
    def from_coo(coo: COO) -> "CSR":
        coo = coo.sort_rowmajor()
        indptr = np.zeros(coo.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, coo.row + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, coo.col, coo.val, coo.shape)

    def to_coo(self) -> COO:
        rows = np.repeat(
            np.arange(self.shape[0], dtype=np.int32), self.row_nnz()
        )
        return COO(rows, self.indices.copy(), self.data.copy(), self.shape)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr), shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        m.sort_indices()
        return CSR(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data, m.shape)


@dataclasses.dataclass(repr=False)
class CSC(SparseFormat):
    """Compressed Sparse Column (paper Sec. 2.1)."""

    indptr: np.ndarray
    indices: np.ndarray  # row indices
    data: np.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        self.indptr = _as1d(self.indptr, np.int64)
        self.indices = _as1d(self.indices, np.int32)
        self.data = _as1d(self.data)
        if self.indptr.shape[0] != self.shape[1] + 1:
            raise ValueError("indptr length must be cols+1")

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def col_slice(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[j]), int(self.indptr[j + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        cols = np.repeat(np.arange(self.shape[1]), np.diff(self.indptr))
        out[self.indices, cols] = self.data
        return out

    @staticmethod
    def fromdense(a: np.ndarray) -> "CSC":
        coo = COO.fromdense(a)
        order = np.lexsort((coo.row, coo.col))
        r, c, v = coo.row[order], coo.col[order], coo.val[order]
        indptr = np.zeros(a.shape[1] + 1, dtype=np.int64)
        np.add.at(indptr, c + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSC(indptr, r, v, a.shape)

    def to_coo(self) -> COO:
        cols = np.repeat(
            np.arange(self.shape[1], dtype=np.int32), np.diff(self.indptr)
        )
        return COO(self.indices.copy(), cols, self.data.copy(), self.shape)


@dataclasses.dataclass(repr=False)
class CSV(SparseFormat):
    """The paper's Compressed Sparse Vector format (Sec. 3, Fig. 2).

    Nonzeros are stored in vector-major order: rows are partitioned into
    groups of ``num_pe`` consecutive rows; nonzeros of a group are sorted by
    ``(col, row)``. Attributes per nonzero: ``val``, ``row_ind``,
    ``col_ind`` (the paper's VAL / ROW_INDEX / COL_INDEX).

    A *CSV vector* is the run of consecutive entries inside one row-group
    sharing the same column index — exactly the set of A-nonzeros that share
    one buffered row of B in the Sec. 4.1 buffering scheme.
    """

    val: np.ndarray
    row_ind: np.ndarray
    col_ind: np.ndarray
    shape: Tuple[int, int]
    num_pe: int

    def __post_init__(self):
        self.val = _as1d(self.val)
        self.row_ind = _as1d(self.row_ind, np.int32)
        self.col_ind = _as1d(self.col_ind, np.int32)
        if self.num_pe < 1:
            raise ValueError("num_pe must be >= 1")

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def group_of(self) -> np.ndarray:
        """Row-group id of every stored nonzero."""
        return self.row_ind // self.num_pe

    def vector_id(self) -> np.ndarray:
        """Integer id of the CSV vector each nonzero belongs to.

        A vector is identified by ``(row_group, col)``. Ids are assigned in
        storage order; by construction entries of the same vector are
        consecutive.
        """
        if self.nnz == 0:
            return np.zeros(0, dtype=np.int64)
        g = self.group_of().astype(np.int64)
        c = self.col_ind.astype(np.int64)
        change = np.empty(self.nnz, dtype=bool)
        change[0] = True
        change[1:] = (g[1:] != g[:-1]) | (c[1:] != c[:-1])
        return np.cumsum(change) - 1

    def num_vectors(self) -> int:
        vid = self.vector_id()
        return int(vid[-1]) + 1 if vid.size else 0

    def validate(self) -> None:
        """Assert the storage order is exactly the paper's vector-major order."""
        g = self.group_of().astype(np.int64)
        key = (g, self.col_ind.astype(np.int64), self.row_ind.astype(np.int64))
        order = np.lexsort(key[::-1])  # lexsort: last key is primary
        if not np.array_equal(order, np.arange(self.nnz)):
            raise ValueError("CSV entries are not in vector-major order")

    def to_coo(self) -> COO:
        return COO(self.row_ind.copy(), self.col_ind.copy(), self.val.copy(), self.shape)

    def todense(self) -> np.ndarray:
        return self.to_coo().todense()

    @staticmethod
    def from_coo(coo: COO, num_pe: int) -> "CSV":
        """Host pre-processing (paper Sec. 4.3): convert to vector-major order."""
        g = (coo.row // num_pe).astype(np.int64)
        order = np.lexsort(
            (coo.row.astype(np.int64), coo.col.astype(np.int64), g)
        )
        return CSV(
            coo.val[order],
            coo.row[order],
            coo.col[order],
            coo.shape,
            num_pe,
        )

    @staticmethod
    def fromdense(a: np.ndarray, num_pe: int) -> "CSV":
        return CSV.from_coo(COO.fromdense(a), num_pe)


@dataclasses.dataclass(repr=False)
class BCSR(SparseFormat):
    """Block CSR: nonzero (bm, bn) tiles in block-row-major order.

    Used for the second input matrix of the block-Gustavson kernel (the
    analogue of the paper storing B in CSR, Sec. 4.2.2).
    """

    indptr: np.ndarray  # [n_brows + 1]
    indices: np.ndarray  # [nnzb] block-column ids
    blocks: np.ndarray  # [nnzb, bm, bn]
    shape: Tuple[int, int]

    def __post_init__(self):
        self.indptr = _as1d(self.indptr, np.int64)
        self.indices = _as1d(self.indices, np.int32)
        self.blocks = np.ascontiguousarray(self.blocks)
        if self.blocks.ndim != 3:
            raise ValueError("blocks must be [nnzb, bm, bn]")

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (int(self.blocks.shape[1]), int(self.blocks.shape[2]))

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def nnz(self) -> int:
        # Count of explicitly stored entries (a dense tile's worth each).
        return int(np.count_nonzero(self.blocks))

    @property
    def grid(self) -> Tuple[int, int]:
        bm, bn = self.block_shape
        return (self.shape[0] // bm, self.shape[1] // bn)

    def todense(self) -> np.ndarray:
        bm, bn = self.block_shape
        out = np.zeros(self.shape, dtype=self.blocks.dtype)
        n_brows = self.indptr.shape[0] - 1
        for bi in range(n_brows):
            lo, hi = int(self.indptr[bi]), int(self.indptr[bi + 1])
            for k in range(lo, hi):
                bj = int(self.indices[k])
                out[bi * bm : (bi + 1) * bm, bj * bn : (bj + 1) * bn] = self.blocks[k]
        return out

    @staticmethod
    def fromdense(a: np.ndarray, block_shape: Tuple[int, int]) -> "BCSR":
        bm, bn = block_shape
        m, n = a.shape
        if m % bm or n % bn:
            raise ValueError(f"shape {a.shape} not divisible by block {block_shape}")
        gm, gn = m // bm, n // bn
        tiles = a.reshape(gm, bm, gn, bn).transpose(0, 2, 1, 3)
        mask = np.any(tiles != 0, axis=(2, 3))
        indptr = np.zeros(gm + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(mask.sum(axis=1))
        brows, bcols = np.nonzero(mask)
        return BCSR(indptr, bcols.astype(np.int32), tiles[brows, bcols], (m, n))

    def to_coo(self) -> "COO":
        """Element-level COO of the stored entries (never densifies)."""
        bm, bn = self.block_shape
        s, r, c = np.nonzero(self.blocks)
        brows = np.repeat(
            np.arange(self.indptr.shape[0] - 1, dtype=np.int64),
            np.diff(self.indptr),
        )
        row = brows[s] * bm + r
        col = self.indices[s].astype(np.int64) * bn + c
        return COO(
            row.astype(np.int32), col.astype(np.int32), self.blocks[s, r, c],
            self.shape,
        )


@dataclasses.dataclass(repr=False)
class BCSV(SparseFormat):
    """Block CSV — the paper's CSV format at tile granularity.

    Nonzero (bm, bk) tiles stored vector-major: block-rows are partitioned
    into groups of ``group`` block-rows; within a group tiles are sorted by
    ``(bcol, brow)``. The packed ``blocks`` array is therefore one
    sequential stream, and consecutive tiles sharing ``bcol`` meet the same
    B block-row (paper Sec. 4.1 buffering scheme at tile granularity).
    ``group`` plays the role of NUM_PE.
    """

    blocks: np.ndarray  # [nnzb, bm, bk]
    brow: np.ndarray  # [nnzb]
    bcol: np.ndarray  # [nnzb]
    group_ptr: np.ndarray  # [n_groups + 1] offsets into the nnzb axis
    shape: Tuple[int, int]
    group: int

    def __post_init__(self):
        self.blocks = np.ascontiguousarray(self.blocks)
        self.brow = _as1d(self.brow, np.int32)
        self.bcol = _as1d(self.bcol, np.int32)
        self.group_ptr = _as1d(self.group_ptr, np.int64)
        if self.blocks.ndim != 3:
            raise ValueError("blocks must be [nnzb, bm, bk]")

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (int(self.blocks.shape[1]), int(self.blocks.shape[2]))

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.blocks))

    @property
    def grid(self) -> Tuple[int, int]:
        bm, bk = self.block_shape
        return (self.shape[0] // bm, self.shape[1] // bk)

    @property
    def n_groups(self) -> int:
        return int(self.group_ptr.shape[0]) - 1

    def group_of(self) -> np.ndarray:
        return self.brow // self.group

    def validate(self) -> None:
        g = self.group_of().astype(np.int64)
        key = (g, self.bcol.astype(np.int64), self.brow.astype(np.int64))
        order = np.lexsort(key[::-1])
        if not np.array_equal(order, np.arange(self.nnzb)):
            raise ValueError("BCSV blocks are not in vector-major order")
        # group_ptr consistency
        gm = self.grid[0]
        n_groups = -(-gm // self.group)
        if self.n_groups != n_groups:
            raise ValueError("group_ptr has wrong number of groups")
        for gi in range(n_groups):
            lo, hi = int(self.group_ptr[gi]), int(self.group_ptr[gi + 1])
            if not np.all(g[lo:hi] == gi):
                raise ValueError(f"group_ptr[{gi}] range holds foreign blocks")

    def todense(self) -> np.ndarray:
        bm, bk = self.block_shape
        out = np.zeros(self.shape, dtype=self.blocks.dtype)
        for i in range(self.nnzb):
            r, c = int(self.brow[i]), int(self.bcol[i])
            out[r * bm : (r + 1) * bm, c * bk : (c + 1) * bk] = self.blocks[i]
        return out

    def to_coo(self) -> "COO":
        """Element-level COO of the stored entries (never densifies)."""
        bm, bk = self.block_shape
        s, r, c = np.nonzero(self.blocks)
        row = self.brow[s].astype(np.int64) * bm + r
        col = self.bcol[s].astype(np.int64) * bk + c
        return COO(
            row.astype(np.int32), col.astype(np.int32), self.blocks[s, r, c],
            self.shape,
        )

    @staticmethod
    def fromdense(
        a: np.ndarray, block_shape: Tuple[int, int], group: int
    ) -> "BCSV":
        bm, bk = block_shape
        m, k = a.shape
        if m % bm or k % bk:
            raise ValueError(f"shape {a.shape} not divisible by block {block_shape}")
        gm, gk = m // bm, k // bk
        tiles = a.reshape(gm, bm, gk, bk).transpose(0, 2, 1, 3)
        mask = np.any(tiles != 0, axis=(2, 3))
        brows, bcols = np.nonzero(mask)
        g = brows // group
        order = np.lexsort((brows, bcols, g))
        brows, bcols = brows[order], bcols[order]
        blocks = tiles[brows, bcols]
        n_groups = -(-gm // group)
        group_ptr = np.zeros(n_groups + 1, dtype=np.int64)
        np.add.at(group_ptr, (brows // group) + 1, 1)
        np.cumsum(group_ptr, out=group_ptr)
        return BCSV(
            blocks,
            brows.astype(np.int32),
            bcols.astype(np.int32),
            group_ptr,
            (m, k),
            group,
        )
