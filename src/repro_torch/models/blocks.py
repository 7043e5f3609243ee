"""Decoder blocks: pre-norm attention + MLP or MoE, composed per the
config's ``block_pattern``.

The port of ``repro.models.blocks`` for ``attn`` mixers and ``mlp``,
``moe`` (or ``none``) feed-forwards. SSM mixers wait for their module and
raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.attention import attn_decode, attn_forward, attn_t
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.mlp import mlp_forward, mlp_t
from repro_torch.models.moe import moe_forward, moe_t
from repro_torch.models.nn import rmsnorm, rmsnorm_t

__all__ = ["block_t", "block_forward", "block_decode"]


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer == "ssm":
        raise NotImplementedError(
            "SSM (Mamba2/SSD) mixers are not ported yet (ROADMAP queue 1, item 5: SSM and "
            "the frontends)"
        )
    if spec.mixer != "attn" or spec.ff not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown block spec {spec}")


def block_t(cfg: ModelConfig, spec: BlockSpec) -> Dict:
    _check_spec(spec)
    t = {"ln1": rmsnorm_t(cfg.d_model), "mixer": attn_t(cfg)}
    if spec.ff != "none":
        t["ln2"] = rmsnorm_t(cfg.d_model)
        t["ff"] = mlp_t(cfg) if spec.ff == "mlp" else moe_t(cfg)
    return t


def block_forward(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: BlockSpec,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe_aux_loss); the aux loss is 0 without MoE."""
    _check_spec(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn_forward(p["mixer"], h, cfg, positions)
    if spec.ff == "none":
        return x, aux
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if spec.ff == "mlp":
        return x + mlp_forward(p["ff"], h, cfg), aux
    h, aux = moe_forward(p["ff"], h, cfg)
    return x + h, aux


def block_decode(
    p,
    x: torch.Tensor,  # [B, 1, D]
    cfg: ModelConfig,
    spec: BlockSpec,
    pos: int,
    kv: Tuple[torch.Tensor, torch.Tensor],
):
    """One decode step through one block. Returns (x, (cache_k, cache_v)),
    the cache written in place (see :func:`attn_decode`)."""
    _check_spec(spec)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, ck, cv = attn_decode(p["mixer"], h, kv[0], kv[1], pos, cfg)
    x = x + h
    if spec.ff == "none":
        return x, (ck, cv)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if spec.ff == "mlp":
        return x + mlp_forward(p["ff"], h, cfg), (ck, cv)
    h, _ = moe_forward(p["ff"], h, cfg)
    return x + h, (ck, cv)
