"""The LM assembly: embedding -> layers -> norm -> tied head.

The port of ``repro.models.transformer`` for text-only models whose blocks
are attention + MLP or attention + MoE; ``forward`` sums the MoE layers'
load-balance losses into its aux output, as the reference does. The
reference scans over layer periods with stacked parameters; the port keeps one parameter tree per layer
(``params["layers"]``, an ``nn.ModuleList`` of ``n_layers`` trees, layer
``i`` of pattern position ``i % period``) and loops over them in Python.
The reference's remat policy (``cfg.remat``) trades memory for recompute
in the backward pass and has no meaning in inference; its sharding
annotations and scheduling fences have no counterpart on one card.
``lm_loss`` comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import init_kv_cache
from repro_torch.models.blocks import block_decode, block_forward, block_t
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import (
    dense,
    dense_t,
    embed_lookup,
    embedding_t,
    init_params,
    rmsnorm,
    rmsnorm_t,
)
from repro_torch.kernels.backend import resolve_device

__all__ = ["lm_template", "init_lm", "forward", "decode_step", "init_cache"]


def lm_template(cfg: ModelConfig) -> Dict:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            "(ROADMAP queue 1, item 16)"
        )
    t: Dict = {
        "embed": embedding_t(cfg.vocab_padded, cfg.d_model),
        "layers": [block_t(cfg, cfg.block_pattern[i % cfg.period])
                   for i in range(cfg.n_layers)],
        "final_norm": rmsnorm_t(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = dense_t(cfg.d_model, cfg.vocab_padded)
    return t


def init_lm(seed: int, cfg: ModelConfig, *, device="cuda") -> nn.Module:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default the
    card; raises without one), drawn from a ``torch.Generator`` on that
    device seeded with ``seed`` (where the reference takes a PRNG key)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(lm_template(cfg), gen, cfg.params_dtype(), device)


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens, cfg.compute_dtype())


def _head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].to(h.dtype).T
    else:
        logits = dense(params["lm_head"], h)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.vocab_padded != cfg.vocab:
        # Mask the padded vocabulary tail (never sampled).
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab
        logits = logits.float().masked_fill(pad, -1e30).to(logits.dtype)
    return logits


def _check_text(cfg: ModelConfig, tokens, feats) -> None:
    if feats is not None or cfg.frontend != "none":
        raise NotImplementedError("only text models are ported (ROADMAP queue 1, item 16)")
    if tokens is None:
        raise ValueError("tokens are required")


def forward(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V], moe_aux scalar)."""
    _check_text(cfg, tokens, feats)
    h = _embed_inputs(params, cfg, tokens)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, layer in enumerate(params["layers"]):
        h, a = block_forward(layer, h, cfg, cfg.block_pattern[i % cfg.period], positions)
        aux = aux + a
    return _head(params, h, cfg), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device="cuda") -> Dict:
    """Decode cache: the position (a Python int) and the KV cache of every
    layer, in the compute dtype on ``device``."""
    return {
        "pos": 0,
        "kv": init_kv_cache(cfg, batch, max_seq, cfg.n_layers, cfg.compute_dtype(),
                            resolve_device(device)),
    }


def decode_step(
    params,
    cache: Dict,
    cfg: ModelConfig,
    token: torch.Tensor,  # [B, 1] int
) -> Tuple[torch.Tensor, Dict]:
    """One token of autoregressive decode. Returns (logits [B,1,V], cache).

    The returned cache holds the next position and the same KV tensors,
    written in place (the reference returns new arrays).
    """
    h = embed_lookup(params["embed"], token, cfg.compute_dtype())
    pos = int(cache["pos"])
    ck, cv = cache["kv"]["k"], cache["kv"]["v"]
    for i, layer in enumerate(params["layers"]):
        h, _ = block_decode(layer, h, cfg, cfg.block_pattern[i % cfg.period], pos,
                            kv=(ck[i], cv[i]))
    logits = _head(params, h, cfg)
    return logits, {"pos": pos + 1, "kv": cache["kv"]}
