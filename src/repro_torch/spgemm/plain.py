"""The plain product of a chain of sparse matrices, ``A1·A2·...·An``: the
reference the port's chains (:func:`~repro_torch.spgemm.execute_chain`)
are held against, in plain PyTorch, with no kernel of the port.

Each stage forms every pair ``X[i,k]·B[k,j]`` of its two operands and sums
it into its coordinate with ``index_add_``, in float64. A stage's pattern
is structural, as a plan's output is: every ``(i, j)`` that some pair
reaches, entries that sum to zero included, so the next stage multiplies
the same pattern the program's next stage does. ``intermediate=
torch.float32`` rounds each intermediate product to float32 before the
next stage, as the program hands one stage's float32 values to the next.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.sparse.formats import COO

__all__ = ["chain_product", "product"]


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device).long()


def product(a: COO, b: COO, *, device="cpu") -> COO:
    """``a @ b`` on its structural pattern, in float64, as canonical COO
    (row-major, one entry per coordinate). The operands may hold
    duplicate coordinates and come in any order."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims differ: {a.shape} x {b.shape}")
    k, n = int(b.shape[0]), int(b.shape[1])
    a_row, a_col = _long(a.row, device), _long(a.col, device)
    b_row, b_col = _long(b.row, device), _long(b.col, device)
    a_val = torch.as_tensor(np.asarray(a.val), device=device).double()
    b_val = torch.as_tensor(np.asarray(b.val), device=device).double()
    # B's entries grouped by row: row k's entries are by_row[start[k]:start[k] + len[k]].
    by_row = torch.argsort(b_row, stable=True)
    b_len = torch.bincount(b_row, minlength=k)
    b_start = torch.cumsum(b_len, 0) - b_len
    cnt = b_len[a_col]
    pairs = int(cnt.sum())
    a_idx = torch.repeat_interleave(torch.arange(a_row.shape[0], device=device), cnt)
    first = (torch.cumsum(cnt, 0) - cnt)[a_idx]
    b_idx = by_row[b_start[a_col][a_idx] + torch.arange(pairs, device=device) - first]
    keys, inverse = torch.unique(a_row[a_idx] * n + b_col[b_idx], sorted=True,
                                 return_inverse=True)
    val = torch.zeros(keys.shape[0], dtype=torch.float64, device=device)
    val.index_add_(0, inverse, a_val[a_idx] * b_val[b_idx])
    rows = torch.div(keys, n, rounding_mode="floor")
    return COO(rows.cpu().numpy(), (keys - rows * n).cpu().numpy(), val.cpu().numpy(),
               (int(a.shape[0]), n))


def chain_product(operands: Sequence[COO], *, intermediate: Optional[torch.dtype] = None,
                  device="cpu") -> COO:
    """``operands[0] @ operands[1] @ ...``, left to right, in float64 (see
    :func:`product`); ``intermediate`` (e.g. ``torch.float32``) rounds the
    values of every product but the last to that dtype."""
    operands = list(operands)
    if len(operands) < 2:
        raise ValueError("a chain multiplies at least two operands")
    out = operands[0]
    for s, b in enumerate(operands[1:], 1):
        out = product(out, b, device=device)
        if intermediate is not None and s < len(operands) - 1:
            val = torch.from_numpy(out.val).to(intermediate).double().numpy()
            out = COO(out.row, out.col, val, out.shape)
    return out
