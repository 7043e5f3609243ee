"""Plain PyTorch versions of the hand-written kernels.

Each function computes the same result as its kernel with ordinary tensor
ops. They are the CPU backend of the port (``backend="torch"``) and the
tolerance oracle the kernels are held against on the card. On the card
they are never bitwise oracles for float inputs: CUDA's float
``index_add_`` adds in an order that changes from run to run.
"""
from __future__ import annotations

import torch

__all__ = ["spgemm_scheduled_batch_ref", "spgemm_scheduled_ref"]


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
    ``[n_panels, group*bm, bn]`` in float32.
    """
    dev = a_blocks.device
    bm = a_blocks.shape[1]
    bn = b_blocks.shape[2]
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
