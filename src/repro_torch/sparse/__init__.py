"""Sparse matrix formats and utilities (host-side numpy).

The paper's Compressed Sparse Vector (CSV) format (Sec. 3), the standard
formats it is defined against (COO/CSR/CSC), and the block variants
(BCSR/BCSV) the block-Gustavson kernel consumes.
"""
from repro_torch.sparse.formats import (
    COO,
    CSR,
    CSC,
    CSV,
    BCSR,
    BCSV,
    SparseFormat,
)
from repro_torch.sparse import convert, random

__all__ = [
    "COO",
    "CSR",
    "CSC",
    "CSV",
    "BCSR",
    "BCSV",
    "SparseFormat",
    "convert",
    "random",
]
