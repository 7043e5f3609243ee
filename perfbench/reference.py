"""The plain reference of C = A·B and the comparison that decides ``correct``.

Plain PyTorch, on whatever device it is given (the card in a run, the CPU
in the tests). It takes the benchmark's own inputs (canonical COO patterns
from ``gen`` and value vectors) and nothing the program made, and works C
out again: every product ``A[i,k]·B[k,j]`` is formed and summed into its
coordinate in float64. The output's pattern is the structural product
pattern: each ``(i, j)`` with at least one pair of stored entries.

``compare`` judges one CSR result of the program against it as a matrix:
every entry of the structural pattern present with the right value, every
other stored entry exactly zero (a block output stores the zero fill of
its blocks), a well-formed CSR. The value error of an entry is measured
against the sum of the magnitudes of its products, the scale that bounds
any summation order's rounding error.
"""
from __future__ import annotations

import numpy as np
import torch

# Stands in for a non-finite error, so that a result line stays JSON.
NONFINITE = 1e30


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


class ExactProduct:
    """The structural product pattern of two canonical COO patterns, and
    the pairs of entries that build each of its coordinates."""

    def __init__(self, a, b, device):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"inner dims differ: {a.shape} x {b.shape}")
        self.device = torch.device(device)
        self.shape = (a.shape[0], b.shape[1])
        n = self.shape[1]
        a_row = _tensor(a.row, device, torch.int64)
        a_col = _tensor(a.col, device, torch.int64)
        b_row = _tensor(b.row, device, torch.int64)
        b_col = _tensor(b.col, device, torch.int64)
        b_len = torch.bincount(b_row, minlength=b.shape[0])
        b_start = torch.cumsum(b_len, 0) - b_len
        cnt = b_len[a_col]
        pairs = int(cnt.sum())
        self.a_idx = torch.repeat_interleave(torch.arange(a.nnz, device=device), cnt)
        first = (torch.cumsum(cnt, 0) - cnt)[self.a_idx]
        self.b_idx = b_start[a_col][self.a_idx] + (
            torch.arange(pairs, device=device) - first)
        keys = a_row[self.a_idx] * n + b_col[self.b_idx]
        self.keys, self.inverse = torch.unique(keys, sorted=True, return_inverse=True)
        self.pairs = pairs

    @property
    def nnz(self) -> int:
        return int(self.keys.shape[0])

    def values(self, a_vals, b_vals):
        """C's values on the pattern, in float64, and the sum of the
        magnitudes of each entry's products."""
        p = (_tensor(a_vals, self.device, torch.float64)[self.a_idx]
             * _tensor(b_vals, self.device, torch.float64)[self.b_idx])
        c = torch.zeros(self.nnz, dtype=torch.float64, device=self.device)
        s = torch.zeros_like(c)
        c.index_add_(0, self.inverse, p)
        s.index_add_(0, self.inverse, p.abs())
        return c, s

    def control(self, a_vals, b_vals) -> np.ndarray:
        """The reference one precision down: operands rounded to TF32 (10
        mantissa bits, to nearest even), products and sums in float32. The
        program computes in float32 with TF32 off, so a program that
        stepped down to TF32 would read like this."""
        a = tf32(_tensor(a_vals, self.device, torch.float32))
        b = tf32(_tensor(b_vals, self.device, torch.float32))
        c = torch.zeros(self.nnz, dtype=torch.float32, device=self.device)
        c.index_add_(0, self.inverse, a[self.a_idx] * b[self.b_idx])
        return c.cpu().numpy()

    def csr(self, data: np.ndarray):
        """``(indptr, indices, data)`` of ``data`` on the exact pattern."""
        m, n = self.shape
        rows = torch.div(self.keys, n, rounding_mode="floor")
        indptr = torch.zeros(m + 1, dtype=torch.int64, device=self.device)
        indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
        return (indptr.cpu().numpy(), (self.keys - rows * n).to(torch.int32).cpu().numpy(),
                data)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def compare(exact: ExactProduct, c_ref: torch.Tensor, scale: torch.Tensor,
            indptr, indices, data) -> dict:
    """One CSR result against the reference's ``c_ref`` (float64 on the
    pattern) and ``scale``: ``c_err``, the largest error of an entry over
    the magnitude of its products; ``c_missing``, entries of the pattern
    the result does not store; ``c_extra``, stored entries off the pattern
    that are not zero; ``c_structure``, a malformed CSR (1) or duplicate
    coordinates (their count)."""
    dev = exact.device
    m, n = exact.shape
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    nnz = int(indices.shape[0])
    bad = {"c_err": NONFINITE, "c_missing": exact.nnz, "c_extra": 0, "c_structure": 1}
    if (indptr.shape != (m + 1,) or data.shape != (nnz,) or int(indptr[0]) != 0
            or int(indptr[-1]) != nnz or np.any(np.diff(indptr) < 0)
            or (nnz and (int(indices.min()) < 0 or int(indices.max()) >= n))):
        return bad
    counts = _tensor(np.diff(indptr), dev, torch.int64)
    rows = torch.repeat_interleave(torch.arange(m, device=dev), counts)
    keys = rows * n + _tensor(indices, dev, torch.int64)
    del rows
    vals = _tensor(np.asarray(data, np.float32), dev, torch.float64)
    if nnz > 1 and not bool((keys[1:] > keys[:-1]).all()):
        keys, order = torch.sort(keys)
        vals = vals[order]
        del order
    dups = int((keys[1:] == keys[:-1]).sum()) if nnz > 1 else 0
    if nnz == 0:
        return {"c_err": 0.0 if exact.nnz == 0 else NONFINITE, "c_missing": exact.nnz,
                "c_extra": 0, "c_structure": 0}
    pos = torch.searchsorted(keys, exact.keys).clamp_(max=nnz - 1)
    found = keys[pos] == exact.keys
    missing = int((~found).sum())
    err = (vals[pos] - c_ref).abs_() / scale
    err = torch.nan_to_num(err[found], nan=NONFINITE, posinf=NONFINITE)
    matched = torch.zeros(nnz, dtype=torch.bool, device=dev)
    matched[pos[found]] = True
    extra = int(((vals != 0) & ~matched).sum())
    worst = float(err.max()) if err.numel() else 0.0
    return {"c_err": min(worst, NONFINITE), "c_missing": missing, "c_extra": extra,
            "c_structure": dups}
