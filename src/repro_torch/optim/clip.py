"""Global-norm gradient clipping over a tree of tensors."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.models.tree import tree_leaves, tree_map

__all__ = ["clip_by_global_norm", "clip_leaves", "global_norm"]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_leaves(leaves: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every tensor of the list by min(1, max_norm / (norm + 1e-9)),
    each in its own dtype, as the reference does (a float32 product would
    widen a bf16 gradient tree); returns the norm. Each entry is replaced
    by its scaled copy as the loop reaches it, so that a caller who holds
    the leaves only through this list frees each old one at once: a train
    step then holds one gradient tree and one leaf more, not two trees."""
    norm = global_norm(leaves)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for i, x in enumerate(leaves):
        leaves[i] = x * scale.to(x.dtype)
    return norm


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(tree scaled by :func:`clip_leaves`, norm)."""
    leaves = tree_leaves(tree)
    norm = clip_leaves(leaves, max_norm)
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree), norm
