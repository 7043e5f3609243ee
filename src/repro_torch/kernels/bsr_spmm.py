"""Block-sparse-weight matmul (SpMM) kernel: the wrapper of ``csrc/bsr_spmm.cu``.

The port of ``repro.kernels.bsr_spmm`` (the TPU kernel K3): y = x @ W for
a dense activation x [M, K] and a block-sparse weight W [K, N] whose
nonzero blocks are stored column-panel-major, so that every output column
panel's blocks are consecutive. :func:`plan_bsr` is the reference's host
ordering, a numpy copy.

The CUDA kernel gives each thread block one (row tile, column panel) and
walks the panel's run of blocks itself, from per-panel offsets derived
here from the sorted ``w_bcol``; it needs no first/last run flags, which
are checked for shape and kept for the reference's signature. The float32
sum stays in registers and the tile is written once. It matches the TPU
kernel within tolerance (its own summation tiles), not bit for bit; the
reference's ``interpret`` option has no counterpart.

:func:`bsr_spmm` launches the kernel for CUDA tensors and raises on
anything it does not accept. For CPU tensors it computes the same result
with the plain version, :func:`repro_torch.kernels.ref.bsr_spmm_ref`. Its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_bsr_spmm

__all__ = ["bsr_spmm", "plan_bsr"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_LIMIT = 1 << 31


def plan_bsr(
    w_brow: np.ndarray, w_bcol: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Column-panel-major ordering + run flags for the kernel.

    Returns (order, brow_sorted, bcol_sorted, flags) where flags[t] is
    1 for the first block of a bcol run, 2 for the last, 3 for both.
    """
    order = np.lexsort((w_brow, w_bcol))
    br, bc = w_brow[order], w_bcol[order]
    t = br.shape[0]
    first = np.empty(t, bool)
    last = np.empty(t, bool)
    first[0] = True
    first[1:] = bc[1:] != bc[:-1]
    last[-1] = True
    last[:-1] = bc[1:] != bc[:-1]
    flags = first.astype(np.int32) + 2 * last.astype(np.int32)
    return order, br.astype(np.int32), bc.astype(np.int32), flags


def _host_index(a, name: str) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"{name} must be a 1-D integer array")
    return a.astype(np.int64)


def _launch(x, w_blocks, brow: np.ndarray, bcol: np.ndarray, n: int) -> torch.Tensor:
    m, k = (int(d) for d in x.shape)
    nnzb, bk, bn = (int(d) for d in w_blocks.shape)
    if bk % 16 or bn % 4:
        raise ValueError(
            f"the CUDA kernel takes bk a multiple of 16 and bn a multiple of 4; "
            f"bk={bk}, bn={bn}"
        )
    if n // bn > 65535 or bn > 64 * 128:
        raise ValueError(f"the CUDA kernel takes at most 65535 column panels of at most "
                         f"8192 columns; {n // bn} of {bn}")
    if max(m, k, n, nnzb) >= _INT_LIMIT:
        raise ValueError("sizes must stay below 2**31")
    for name, t in (("x", x), ("w_blocks", w_blocks)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    n_panels = n // bn
    # Panel p's run is bcol's entries equal to p (bcol is sorted).
    panel_ptr = np.searchsorted(bcol, np.arange(n_panels + 1), side="left").astype(np.int32)
    dev = x.device
    panel_ptr_d = torch.from_numpy(panel_ptr).to(dev)
    brow_d = torch.from_numpy(brow.astype(np.int32)).to(dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    lib = load_bsr_spmm()
    with torch.cuda.device(dev):
        err = lib.bsr_spmm_launch(
            x.data_ptr(), w_blocks.data_ptr(), panel_ptr_d.data_ptr(), brow_d.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], m, k, n, bk, bn,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: cudaError_t {err}")
    bsr_spmm.launches += 1
    return out


def bsr_spmm(
    x: torch.Tensor,  # [M, K] dense (M % tm == 0)
    w_blocks: torch.Tensor,  # [nnzb, bk, bn] in column-panel-major order
    w_brow,  # [nnzb] int (K-block index), numpy array or tensor
    w_bcol,  # [nnzb] int (N-block index), non-decreasing
    flags,  # [nnzb] int run flags from plan_bsr
    *,
    n: int,
    tm: int = 128,
) -> torch.Tensor:
    """y[M, n] = x @ W for block-sparse W, summed and returned in float32
    (the reference's default ``out_dtype``, which no caller changes). Every
    column panel should hold at least one block, as the reference requires
    (``ops.sparse_dense_matmul`` pads empty ones); the kernel writes an
    empty panel as zeros."""
    if not isinstance(x, torch.Tensor) or not isinstance(w_blocks, torch.Tensor):
        raise TypeError("x and w_blocks must be torch tensors")
    if x.device != w_blocks.device:
        raise ValueError(f"x ({x.device}) and w_blocks ({w_blocks.device}) must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or w_blocks.dim() != 3:
        raise ValueError("x must be [M, K] and w_blocks [nnzb, bk, bn]")
    m, k = (int(d) for d in x.shape)
    nnzb, bk, bn = (int(d) for d in w_blocks.shape)
    brow, bcol = _host_index(w_brow, "w_brow"), _host_index(w_bcol, "w_bcol")
    if brow.shape[0] != nnzb or bcol.shape[0] != nnzb or np.shape(flags) != (nnzb,):
        raise ValueError(
            f"w_brow, w_bcol and flags must each hold nnzb={nnzb} entries"
        )
    if tm < 1 or m % tm:
        raise ValueError(f"M={m} must be a multiple of tm={tm}")
    if bk < 1 or bn < 1 or k % bk or n % bn:
        raise ValueError(f"x [{m}, {k}] and n={n} do not tile into [{bk}, {bn}] blocks")
    if nnzb and (brow.min() < 0 or brow.max() >= k // bk or bcol.min() < 0
                 or bcol.max() >= n // bn):
        raise ValueError("block indices outside W's block grid")
    if np.any(np.diff(bcol) < 0):
        raise ValueError("w_bcol must be non-decreasing (column-panel-major, see plan_bsr)")
    if x.dtype not in _DTYPE_CODE or w_blocks.dtype != x.dtype:
        raise TypeError(
            f"x and w_blocks must both be float32 or both bfloat16, got "
            f"{x.dtype} and {w_blocks.dtype}"
        )
    if x.device.type == "cpu":
        return ref.bsr_spmm_ref(x, w_blocks, brow, bcol, n)
    return _launch(x, w_blocks, brow, bcol, n)


bsr_spmm.launches = 0
