"""Global-norm gradient clipping over a tree of tensors."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.tree import tree_leaves, tree_map

__all__ = ["clip_by_global_norm", "global_norm"]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(tree scaled by min(1, max_norm / (norm + 1e-9)), norm). Each leaf is
    scaled in its own dtype, as the reference does (an float32 product
    would widen a bf16 gradient tree)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm
