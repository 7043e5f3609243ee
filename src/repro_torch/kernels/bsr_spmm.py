"""Block-sparse-weight matmul (SpMM) kernel: the wrapper of ``csrc/bsr_spmm.cu``.

The port of ``repro.kernels.bsr_spmm`` (the TPU kernel K3): y = x @ W for
a dense activation x [M, K] and a block-sparse weight W [K, N] whose
nonzero blocks are stored column-panel-major, so that every output column
panel's blocks are consecutive. :func:`plan_bsr` is the reference's host
ordering, a numpy copy.

The CUDA kernels give each thread block one (row tile, column panel,
128-column slice) and walk the panel's run of blocks themselves, from
per-panel offsets derived here from the sorted ``w_bcol``; they need no
first/last run flags, which are checked for shape and kept for the
reference's signature. The float32 sum stays in registers and the tile is
written once. Float32 operands run on float32 FMAs (float32 parity rules
out TF32); bfloat16 operands on wgmma fed by TMA, the grouped matmul's
machinery (``csrc/sm90.cuh``). The kernel is picked by dtype, a static
rule: a bfloat16 call the tensor-core kernel cannot take raises. Both
match the TPU kernel within tolerance (their own summation order), not
bit for bit; the reference's ``interpret`` option has no counterpart.

The wrapper is two steps. :func:`stage_bsr_index` checks W's block indices
and copies them to the card (per-panel run offsets and block rows);
:func:`bsr_spmm_staged` launches the kernel on indices staged that way.
:func:`bsr_spmm` does both on every call and keeps nothing between calls.
For CPU tensors it computes the same result with the plain version,
:func:`repro_torch.kernels.ref.bsr_spmm_ref`. ``bsr_spmm.launches`` counts
kernel launches, ``bsr_spmm.bf16_launches`` those of the tensor-core
kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_bsr_spmm

__all__ = ["BsrIndex", "bsr_spmm", "bsr_spmm_staged", "plan_bsr", "stage_bsr_index"]

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


@dataclasses.dataclass(frozen=True)
class BsrIndex:
    """W's block indices as the kernel reads them, on one device: column
    panel p owns blocks ``panel_ptr[p]:panel_ptr[p+1]``, whose block rows
    are in ``brow``."""

    panel_ptr: torch.Tensor  # [n_panels + 1] int32
    brow: torch.Tensor  # [nnzb] int32
    n_panels: int
    k_blocks: int

    @property
    def nnzb(self) -> int:
        return int(self.brow.shape[0])


def stage_bsr_index(w_brow, w_bcol, *, k_blocks: int, n_panels: int, device) -> BsrIndex:
    """Check W's block indices (numpy arrays or tensors, column-panel-major:
    ``w_bcol`` non-decreasing) against a ``k_blocks`` x ``n_panels`` block
    grid and copy them to ``device``."""
    brow, bcol = _host_index(w_brow, "w_brow"), _host_index(w_bcol, "w_bcol")
    if brow.shape != bcol.shape:
        raise ValueError("w_brow and w_bcol must hold the same number of entries")
    if brow.size and (brow.min() < 0 or brow.max() >= k_blocks or bcol.min() < 0
                      or bcol.max() >= n_panels):
        raise ValueError("block indices outside W's block grid")
    if np.any(np.diff(bcol) < 0):
        raise ValueError("w_bcol must be non-decreasing (column-panel-major, see plan_bsr)")
    if max(brow.size, n_panels + 1) >= _INT_LIMIT:
        raise ValueError("sizes must stay below 2**31")
    # Panel p's run is bcol's entries equal to p (bcol is sorted).
    panel_ptr = np.searchsorted(bcol, np.arange(n_panels + 1), side="left").astype(np.int32)
    return BsrIndex(
        panel_ptr=torch.from_numpy(panel_ptr).to(device),
        brow=torch.from_numpy(brow.astype(np.int32)).to(device),
        n_panels=n_panels, k_blocks=k_blocks,
    )


def bsr_spmm_staged(x: torch.Tensor, w_blocks: torch.Tensor, index: BsrIndex,
                    *, n: int) -> torch.Tensor:
    """Launch the kernel for x [M, K] and W's blocks [nnzb, bk, bn] (CUDA
    tensors, column-panel-major) on indices from :func:`stage_bsr_index`
    on the same device; returns y [M, n] float32. Raises on anything the
    kernel does not take."""
    if x.device.type != "cuda" or w_blocks.device != x.device:
        raise ValueError("bsr_spmm_staged launches the CUDA kernel: x and w_blocks must "
                         "be CUDA tensors on one device")
    if index.panel_ptr.device != x.device or index.brow.device != x.device:
        raise ValueError("the staged index must be on x's device")
    if x.dim() != 2 or w_blocks.dim() != 3:
        raise ValueError("x must be [M, K] and w_blocks [nnzb, bk, bn]")
    if x.dtype not in _DTYPE_CODE or w_blocks.dtype != x.dtype:
        raise TypeError(
            f"x and w_blocks must both be float32 or both bfloat16, got "
            f"{x.dtype} and {w_blocks.dtype}"
        )
    m, k = (int(d) for d in x.shape)
    nnzb, bk, bn = (int(d) for d in w_blocks.shape)
    if nnzb != index.nnzb or n != index.n_panels * bn or k != index.k_blocks * bk:
        raise ValueError(f"x [{m}, {k}], {nnzb} blocks of [{bk}, {bn}] and n={n} do not "
                         f"match the staged index ({index.nnzb} blocks, {index.k_blocks} x "
                         f"{index.n_panels} block grid)")
    if bk % 16 or bn % 4:
        raise ValueError(
            f"the CUDA kernel takes bk a multiple of 16 and bn a multiple of 4; "
            f"bk={bk}, bn={bn}"
        )
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and (n // bn > 65535 or bn > 64 * 128):
        raise ValueError(f"the float32 kernel takes at most 65535 column panels of at most "
                         f"8192 columns; {n // bn} of {bn}")
    if max(m, k, n, nnzb) >= _INT_LIMIT:
        raise ValueError("sizes must stay below 2**31")
    if bf16 and bn % 8:
        # TMA reads rows of 16-byte multiples: pad each block's rows to a
        # multiple of 8 values (the padding columns are never written out).
        w_blocks = torch.nn.functional.pad(w_blocks, (0, -bn % 8))
    for name, t in (("x", x), ("w_blocks", w_blocks)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if m == 0 or nnzb == 0:
        # Nothing to multiply: every panel is empty, y is zero.
        return torch.zeros((m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = load_bsr_spmm()
    with torch.cuda.device(x.device):
        err = lib.bsr_spmm_launch(
            x.data_ptr(), w_blocks.data_ptr(), index.panel_ptr.data_ptr(),
            index.brow.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], m, k, n, bk, bn,
            int(w_blocks.shape[2]), nnzb, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: cudaError_t {err}")
    bsr_spmm.launches += 1
    bsr_spmm.bf16_launches += bf16
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
    if x.dtype not in _DTYPE_CODE or w_blocks.dtype != x.dtype:
        raise TypeError(
            f"x and w_blocks must both be float32 or both bfloat16, got "
            f"{x.dtype} and {w_blocks.dtype}"
        )
    index = stage_bsr_index(brow, bcol, k_blocks=k // bk, n_panels=n // bn,
                            device=x.device)
    if x.device.type == "cpu":
        return ref.bsr_spmm_ref(x, w_blocks, brow, bcol, n)
    return bsr_spmm_staged(x, w_blocks, index, n=n)


bsr_spmm.launches = 0
bsr_spmm.bf16_launches = 0
