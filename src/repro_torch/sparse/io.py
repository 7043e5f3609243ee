"""Matrix file I/O (the paper's "raw matrix files", Sec. 4.3).

Supports MatrixMarket (.mtx) coordinate format — the SuiteSparse interchange
format — plus a fast binary container for the pre-processed CSV/BCSV forms
("the pre-processing step only needs to be performed once"). The files are
those of the JAX package's ``sparse.io``: either package reads what the
other wrote.
"""
from __future__ import annotations

from typing import Union

import numpy as np

from repro_torch.sparse.formats import BCSV, COO, CSR, CSV


def read_matrix_market(path: str) -> COO:
    """Minimal MatrixMarket coordinate reader (real/integer/pattern, general
    or symmetric)."""
    with open(path, "r") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        parts = header.lower().split()
        fmt, field, symmetry = parts[2], parts[3], parts[4]
        if fmt != "coordinate":
            raise ValueError("only coordinate format supported")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(x) for x in line.split())
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.empty(nnz, dtype=np.float32)
        for i in range(nnz):
            toks = f.readline().split()
            rows[i] = int(toks[0]) - 1
            cols[i] = int(toks[1]) - 1
            vals[i] = float(toks[2]) if field != "pattern" else 1.0
    if symmetry == "symmetric":
        off = rows != cols  # mirror strictly-off-diagonal entries
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    coo = COO(rows.astype(np.int32), cols.astype(np.int32), vals, (m, n))
    return coo.sum_duplicates()


def write_matrix_market(path: str, a: Union[COO, CSR]) -> None:
    coo = a if isinstance(a, COO) else a.to_coo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        for r, c, v in zip(coo.row, coo.col, coo.val):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v):.9g}\n")


def save_csv(path: str, a: CSV) -> None:
    """Persist a pre-processed CSV matrix (one .npz + manifest)."""
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        val=a.val,
        row_ind=a.row_ind,
        col_ind=a.col_ind,
        shape=np.asarray(a.shape, dtype=np.int64),
        num_pe=np.asarray([a.num_pe], dtype=np.int64),
    )


def load_csv(path: str) -> CSV:
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return CSV(
        z["val"],
        z["row_ind"],
        z["col_ind"],
        tuple(int(x) for x in z["shape"]),
        int(z["num_pe"][0]),
    )


def save_bcsv(path: str, a: BCSV) -> None:
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        blocks=a.blocks,
        brow=a.brow,
        bcol=a.bcol,
        group_ptr=a.group_ptr,
        shape=np.asarray(a.shape, dtype=np.int64),
        group=np.asarray([a.group], dtype=np.int64),
    )


def load_bcsv(path: str) -> BCSV:
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return BCSV(
        z["blocks"],
        z["brow"],
        z["bcol"],
        z["group_ptr"],
        tuple(int(x) for x in z["shape"]),
        int(z["group"][0]),
    )
