"""Int8 error-feedback gradient compression.

The port of ``repro.optim.compress``: per-tensor-scaled int8 quantization
of gradient + residual, with the quantization error carried to the next
step (``ef_compress``), and its data-parallel average
(``compressed_psum``). The reference averages inside ``shard_map`` with
``pmean`` over a mesh axis; the port all-reduces over a
``torch.distributed`` process group that the caller passes. As there, the
sum runs on the dequantized float32 values; the modeled wire payload is
the int8 tensor and one float32 scale per tensor. The reference's other
mechanism, bf16 gradients by way of bf16 compute params, needs no code.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.tree import tree_leaves, tree_map, tree_rebuild

__all__ = ["ef_init", "ef_compress", "ef_decompress", "compressed_psum"]


def ef_init(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    # torch.round rounds half to even, as jnp.round does.
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """(q, scales, new_residual): quantize grad + residual to int8."""
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    pairs = [_quant(c) for c in tree_leaves(corrected)]
    q = tree_rebuild(corrected, [qq for qq, _ in pairs])
    s = tree_rebuild(corrected, [ss for _, ss in pairs])
    new_res = tree_map(lambda c, qq, ss: c - qq.to(torch.float32) * ss, corrected, q, s)
    return q, s, new_res


def ef_decompress(q: Any, s: Any) -> Any:
    return tree_map(lambda qq, ss: qq.to(torch.float32) * ss, q, s)


def compressed_psum(grads: Any, residual: Any, group=None) -> Tuple[Any, Any]:
    """EF-compress, then average the dequantized gradients over ``group``
    (the default process group when None). Returns (average, new
    residual)."""
    q, s, new_res = ef_compress(grads, residual)
    deq = ef_decompress(q, s)
    world = dist.get_world_size(group)

    def mean(g):
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g / world

    return tree_map(mean, deq), new_res
