"""The LM assembly: embedding -> layers -> norm -> tied head.

The port of ``repro.models.transformer`` for text-only models whose blocks
are attention + MLP or attention + MoE; ``forward`` sums the MoE layers'
load-balance losses into its aux output, as the reference does. The
reference scans over layer periods with stacked parameters; the port keeps one parameter tree per layer
(``params["layers"]``, an ``nn.ModuleList`` of ``n_layers`` trees, layer
``i`` of pattern position ``i % period``) and loops over them in Python.

The reference's remat policy (``cfg.remat``) wraps its scan body, one
layer period; the port wraps each layer's ``block_forward`` (for the
ported configs a period is one layer) in ``torch.utils.checkpoint``
when grad is enabled: ``"full"`` keeps only the layer's input and
recomputes the rest in the backward, ``"dots"`` also keeps the outputs
of the matrix products without batch dimensions (``aten.mm`` and
``aten.addmm``; the reference's ``checkpoint_dots_with_no_batch_dims``)
through a selective-checkpoint policy. Under ``torch.no_grad`` (serving)
no layer is wrapped. ``lm_loss`` is the cross-entropy LM loss with the
reference's compute-dtype backward (``_token_nll``). The reference's
sharding annotations (``shard``, ``lm_axes``) and its scheduling fence
(``optimization_barrier``) have no counterpart on one card.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

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

__all__ = ["lm_template", "init_lm", "forward", "decode_step", "init_cache", "lm_loss"]

_NOT_PORTED = "ROADMAP queue 1, item 5: SSM and the frontends"


def lm_template(cfg: ModelConfig) -> Dict:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet ({_NOT_PORTED})"
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


def init_lm(seed: int, cfg: ModelConfig, *, device="cuda", trainable: bool = False) -> nn.Module:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default the
    card; raises without one), drawn from a ``torch.Generator`` on that
    device seeded with ``seed`` (where the reference takes a PRNG key);
    they require grad iff ``trainable``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(lm_template(cfg), gen, cfg.params_dtype(), device, trainable)


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
        raise NotImplementedError(f"only text models are ported ({_NOT_PORTED})")
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
    run = _remat(cfg.remat) if torch.is_grad_enabled() else _call
    for i, layer in enumerate(params["layers"]):
        h, a = run(block_forward, layer, h, cfg, cfg.block_pattern[i % cfg.period], positions)
        aux = aux + a
    return _head(params, h, cfg), aux


# Matrix products without batch dimensions: the outputs that remat "dots"
# keeps (the reference's checkpoint_dots_with_no_batch_dims).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _call(fn, *args):
    return fn(*args)


def _remat(policy: str):
    """A runner ``(fn, *args) -> fn(*args)`` that checkpoints per the
    config's remat policy."""
    if policy == "none":
        return _call
    if policy == "full":
        return functools.partial(_ckpt.checkpoint, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            _ckpt.checkpoint, use_reentrant=False,
            context_fn=functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat policy {policy!r}")


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


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

class _TokenNLL(torch.autograd.Function):
    """Per-token -log p(label), the reference's ``_token_nll``. Its
    backward keeps every [T, V] tensor in the compute dtype: the softmax
    ``exp(logits - lse)`` cast to the logits' dtype, times g, minus g at
    the label (``_token_nll_bwd``)."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - picked.float()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        dt = logits.dtype
        p = torch.exp(logits.float() - lse[..., None]).to(dt)
        dl = p * g[..., None].to(dt)
        dl.scatter_add_(-1, labels[..., None], -g[..., None].to(dt))
        return dl, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _TokenNLL.apply(logits, labels.long())


def lm_loss(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy LM loss over next-token ``labels`` (pre-shifted by the
    pipeline), averaged over ``mask`` (all positions by default). Returns
    (loss + ``router_aux_weight`` * MoE aux, {"loss", "moe_aux"})."""
    logits, aux = forward(params, cfg, tokens=tokens, feats=feats)
    nll = _token_nll(logits, labels)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "moe_aux": aux}
