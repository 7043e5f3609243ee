"""Feed-forward blocks: (gated) MLP and the SparseLinear feature.

The port of ``repro.models.mlp``. With ``sparse_ffn`` the down-projection
weight carries a block-sparse support mask (``wd_mask``, one entry per
``sparse_block``-square block) and is applied as a masked dense product,
as the reference applies it on every path.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Param, dense, dense_t

__all__ = ["mlp_t", "mlp_forward"]


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
