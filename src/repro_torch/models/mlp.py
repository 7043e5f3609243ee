"""Feed-forward blocks: (gated) MLP and the SparseLinear feature.

The port of ``repro.models.mlp``. With ``sparse_ffn`` the down-projection
weight carries a block-sparse support mask (``wd_mask``, one entry per
``sparse_block``-square block) and is applied as a masked dense product,
as the reference applies it on every path. The reference's docstring
has serving dispatch ``kernels.ops.sparse_dense_matmul`` (K3) on the TPU,
but no path of it does; the port's K3 is reached through that entry point
alone, and routing this layer through it waits for a measurement.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Param, dense, dense_t

__all__ = ["mlp_t", "mlp_forward", "sparse_block_mask"]


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation.
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_t(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    t: Dict = {}
    if cfg.mlp_gated:
        t["wg"] = dense_t(d, f)
        t["wu"] = dense_t(d, f)
    else:
        t["wu"] = dense_t(d, f, bias=cfg.attn_bias)
    t["wd"] = dense_t(f, d, bias=(not cfg.mlp_gated and cfg.attn_bias))
    if cfg.sparse_ffn:
        gm, gf = f // cfg.sparse_block, d // cfg.sparse_block
        t["wd_mask"] = Param((gm, gf), "ones")
    return t


def sparse_block_mask(
    generator: torch.Generator, f: int, d: int, block: int, density: float
) -> torch.Tensor:
    """Random block support for SparseLinear (magnitude pruning stand-in):
    [f // block, d // block] float32 on the generator's device, 1 where a
    uniform draw is at or below its ``density`` quantile, and all of row 0
    set so that no column panel is empty. The reference's rule, drawn from
    a ``torch.Generator`` where it takes a PRNG key."""
    gm, gf = f // block, d // block
    u = torch.rand((gm, gf), generator=generator, device=generator.device)
    m = (u <= torch.quantile(u, density)).float()
    m[0, :] = 1.0
    return m


def mlp_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _act(cfg.act)
    if cfg.mlp_gated:
        h = act(dense(p["wg"], x)) * dense(p["wu"], x)
    else:
        h = act(dense(p["wu"], x))
    wd = p["wd"]
    if cfg.sparse_ffn and "wd_mask" in p:
        blk = cfg.sparse_block
        mask = p["wd_mask"].repeat_interleave(blk, 0).repeat_interleave(blk, 1)
        wd = {"w": wd["w"] * mask.to(wd["w"].dtype),
              **({"b": wd["b"]} if "b" in wd else {})}
    return dense(wd, h)
