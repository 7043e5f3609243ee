"""Plain PyTorch versions of the hand-written kernels.

Each function computes the same result as its kernel with ordinary tensor
ops. They are the CPU backend of the port (``backend="torch"``) and the
tolerance oracle the kernels are held against on the card. On the card
they are never bitwise oracles for float inputs: CUDA's float
``index_add_`` adds in an order that changes from run to run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "bsr_spmm_ref",
    "flash_attention_ref",
    "moe_gmm_ref",
    "spgemm_scheduled_batch_ref",
    "spgemm_scheduled_ref",
]

# Tiles of W that moe_gmm_ref gathers at once: it holds at most this many
# float32 weights beside its inputs (256 MB), where gathering one [D, F]
# weight per tile at once would take 4 GB at the MoE prefill's shape.
_GMM_GATHER_FLOATS = 1 << 26


def _as_index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def spgemm_scheduled_ref(
    a_blocks: torch.Tensor,  # [nnzb_a, bm, bk]
    b_blocks: torch.Tensor,  # [nnzb_b, bk, bn]
    a_slot,  # [T] (numpy array or tensor)
    b_slot,  # [T]
    panel,  # [T]
    sub_row,  # [T]
    n_panels: int,
    group: int,
) -> torch.Tensor:
    """Execute the SpGEMM triple schedule densely: for each triple t,
    ``panels[panel[t], sub_row[t]*bm : ..., :] += A[a_slot[t]] @ B[b_slot[t]]``.

    One batched product of every triple's blocks, then one ``index_add_``
    at each product's flat panel-row offset. Returns panels
    ``[n_panels, group*bm, bn]`` in float32. At tile (1, 1, 1) each tile
    is one output entry and its sum runs as the kernel's does
    (:func:`_element_chain`).
    """
    dev = a_blocks.device
    bm = a_blocks.shape[1]
    bn = b_blocks.shape[2]
    if (bm, a_blocks.shape[2], bn) == (1, 1, 1):
        tile = _as_index(panel, dev) * group + _as_index(sub_row, dev)
        out = _element_chain(a_blocks.reshape(-1), b_blocks.reshape(-1), _as_index(a_slot, dev),
                             _as_index(b_slot, dev), tile, n_panels * group)
        return out.reshape(n_panels, group, 1)
    prod = torch.einsum(
        "tij,tjk->tik",
        a_blocks[_as_index(a_slot, dev)].float(),
        b_blocks[_as_index(b_slot, dev)].float(),
    )  # [T, bm, bn]
    # Panels laid out as [n_panels * group * bm, bn]; triple t starts at row
    # panel[t]*group*bm + sub_row[t]*bm.
    row0 = _as_index(panel, dev) * (group * bm) + _as_index(sub_row, dev) * bm
    rows = (row0[:, None] + torch.arange(bm, device=dev)[None, :]).reshape(-1)
    flat = torch.zeros((n_panels * group * bm, bn), dtype=torch.float32, device=dev)
    flat.index_add_(0, rows, prod.reshape(-1, bn))
    return flat.reshape(n_panels, group * bm, bn)


def _element_chain(a, b, a_slot, b_slot, tile, n_tiles: int) -> torch.Tensor:
    """Each tile's sum of ``a[a_slot[t]] * b[b_slot[t]]`` over its pairs in
    their order, as one float32 chain from zero: step ``s`` adds every
    tile's ``s``-th product at once. A product of two float32 (or bfloat16)
    values is exact in float64, so each step rounds once, as the kernel's
    FMA does, up to the rare double rounding of the float64 sum. Returns
    ``[n_tiles]`` float32."""
    order = torch.argsort(tile, stable=True)
    tile = tile[order]
    prod = a[a_slot[order]].double() * b[b_slot[order]].double()
    counts = torch.bincount(tile, minlength=n_tiles)
    pos = torch.arange(tile.shape[0], device=tile.device) - (torch.cumsum(counts, 0) - counts)[tile]
    by_step = torch.argsort(pos, stable=True)
    steps = torch.bincount(pos).tolist() if pos.numel() else []
    acc = torch.zeros(n_tiles, dtype=torch.float32, device=a.device)
    lo = 0
    for size in steps:
        sel = by_step[lo:lo + size]
        lo += size
        t = tile[sel]
        acc[t] = (acc[t].double() + prod[sel]).float()
    return acc


def spgemm_scheduled_batch_ref(
    a_blocks: torch.Tensor,  # [bsz * nnzb_a, bm, bk]
    b_blocks: torch.Tensor,  # [bsz * nnzb_b, bk, bn]
    a_slot,
    b_slot,
    panel,
    sub_row,
    n_panels: int,
    group: int,
    bsz: int,
) -> torch.Tensor:
    """:func:`spgemm_scheduled_ref` for ``bsz`` value sets over one
    schedule. The batch is folded into the schedule (element ``e``'s slot
    and panel indices offset by ``e`` times the per-element counts), which
    keeps each element's accumulation order. Returns
    ``[bsz, n_panels, group*bm, bn]`` float32."""
    dev = a_blocks.device
    off = torch.arange(bsz, device=dev)[:, None]
    a_slots = a_blocks.shape[0] // bsz
    b_slots = b_blocks.shape[0] // bsz
    panels = spgemm_scheduled_ref(
        a_blocks, b_blocks,
        (off * a_slots + _as_index(a_slot, dev)[None, :]).reshape(-1),
        (off * b_slots + _as_index(b_slot, dev)[None, :]).reshape(-1),
        (off * n_panels + _as_index(panel, dev)[None, :]).reshape(-1),
        _as_index(sub_row, dev).repeat(bsz),
        bsz * n_panels, group,
    )
    return panels.reshape((bsz, n_panels) + tuple(panels.shape[1:]))


def bsr_spmm_ref(
    x: torch.Tensor,  # [M, K] dense activations
    w_blocks: torch.Tensor,  # [nnzb, bk, bn]
    w_brow,  # [nnzb] K-block index (numpy array or tensor)
    w_bcol,  # [nnzb] N-block index
    n: int,
) -> torch.Tensor:
    """y = x @ W with W block-sparse: densify W, then one float32 matmul.
    Returns [M, n] float32."""
    dev = x.device
    bk, bn = int(w_blocks.shape[1]), int(w_blocks.shape[2])
    k = int(x.shape[1])
    w = torch.zeros((k // bk, n // bn, bk, bn), dtype=torch.float32, device=dev)
    w[_as_index(w_brow, dev), _as_index(w_bcol, dev)] = w_blocks.float()
    w = w.permute(0, 2, 1, 3).reshape(k, n)
    return x.float() @ w


def moe_gmm_ref(
    x: torch.Tensor,  # [T, D] tokens sorted (grouped) by expert
    w: torch.Tensor,  # [E, D, F]
    tile_expert,  # [T // tm] expert of each token tile (numpy array or tensor)
    tm: int,
) -> torch.Tensor:
    """Grouped matmul: each ``tm``-row tile of x times its expert's W, in
    float32. Tiles are multiplied a chunk at a time (one batched product
    per chunk of tiles, their weights gathered), so that the gathered
    weights stay under ``_GMM_GATHER_FLOATS``. Returns [T, F] float32."""
    t, d = int(x.shape[0]), int(x.shape[1])
    f = int(w.shape[2])
    nt = t // tm
    te = _as_index(tile_expert, x.device)
    xt = x.reshape(nt, tm, d).float()
    out = torch.empty((nt, tm, f), dtype=torch.float32, device=x.device)
    step = max(1, _GMM_GATHER_FLOATS // max(1, d * f))
    for i in range(0, nt, step):
        out[i:i + step] = torch.bmm(xt[i:i + step], w[te[i:i + step]].float())
    return out.reshape(t, f)


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Skv, D]
    v: torch.Tensor,  # [BH, Skv, D]
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention, the plain version of the flash kernel.

    ``q_offset`` positions the query block inside the kv sequence (prefill
    continuation / decode). ``window`` is a sliding-window bound: key j is
    visible to query i iff  i + q_offset - window < j <= i + q_offset
    (when causal). Masked logits are -inf; rows with no visible key (a
    window can leave some) are zero, as in the kernel. Computes in float32
    and returns float32.
    """
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * s
    sq, skv = q.shape[1], k.shape[1]
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask[None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # Fully masked rows give NaN in the softmax; zero them like the kernel.
    probs = torch.where(mask.any(dim=-1)[None, :, None], probs, 0.0)
    return torch.einsum("bqk,bkd->bqd", probs, v.float())
