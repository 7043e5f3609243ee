"""Decoder/encoder blocks: pre-norm mixer (attention or SSD) + FF (MLP,
MoE or none), composed per the config's ``block_pattern``.

The port of ``repro.models.blocks``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.attention import attn_decode, attn_forward, attn_t
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.mlp import mlp_forward, mlp_t
from repro_torch.models.moe import moe_forward, moe_t
from repro_torch.models.nn import rmsnorm, rmsnorm_t
from repro_torch.models.ssm import ssm_decode, ssm_forward, ssm_t

__all__ = ["block_t", "block_forward", "block_decode"]


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in ("attn", "ssm") or spec.ff not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown block spec {spec}")


def block_t(cfg: ModelConfig, spec: BlockSpec) -> Dict:
    _check_spec(spec)
    t = {
        "ln1": rmsnorm_t(cfg.d_model),
        "mixer": attn_t(cfg) if spec.mixer == "attn" else ssm_t(cfg),
    }
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
    if spec.mixer == "attn":
        h = attn_forward(p["mixer"], h, cfg, positions)
    else:
        h = ssm_forward(p["mixer"], h, cfg)
    x = x + h
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
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ssm_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """One decode step through one block. Returns (x, new_kv, new_ssm):
    for an attention mixer the cache ``kv`` written in place (see
    :func:`attn_decode`) and None, for an SSM mixer None and the new
    (state, conv) from ``ssm_state``, which is left as it is."""
    _check_spec(spec)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    new_kv = new_ssm = None
    if spec.mixer == "attn":
        h, ck, cv = attn_decode(p["mixer"], h, kv[0], kv[1], pos, cfg)
        new_kv = (ck, cv)
    else:
        h, st, conv = ssm_decode(p["mixer"], h, ssm_state[0], ssm_state[1], cfg)
        new_ssm = (st, conv)
    x = x + h
    if spec.ff == "none":
        return x, new_kv, new_ssm
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if spec.ff == "mlp":
        h = mlp_forward(p["ff"], h, cfg)
    else:
        h, _ = moe_forward(p["ff"], h, cfg)
    return x + h, new_kv, new_ssm
