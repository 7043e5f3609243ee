"""The LM assembly: embedding/frontend -> layers -> norm -> head. One
forward serves all ten architectures of the registry.

The port of ``repro.models.transformer``. ``forward`` sums the MoE layers'
load-balance losses into its aux output, as the reference does. The
reference scans over layer periods with stacked parameters; the port keeps
one parameter tree per layer (``params["layers"]``, an ``nn.ModuleList`` of
``n_layers`` trees, layer ``i`` of pattern position ``i % period``) and
loops over them in Python.

The reference's remat policy (``cfg.remat``) wraps its scan body, one
layer period; the port wraps each layer's ``block_forward`` in
``torch.utils.checkpoint`` when grad is enabled (the same gradients: a
period's layers are recomputed one by one instead of together):
``"full"`` keeps only the layer's input and recomputes the rest in the
backward, ``"dots"`` also keeps the outputs of the matrix products
without batch dimensions (``aten.mm`` and ``aten.addmm``; the reference's
``checkpoint_dots_with_no_batch_dims``) through a selective-checkpoint
policy. Under ``torch.no_grad`` (serving) no layer is wrapped.
``lm_loss`` is the cross-entropy LM loss with the reference's
compute-dtype backward (``_token_nll``).

The decode cache holds the KV cache of the attention layers and the
(state, conv) of the SSM layers, each stacked over its own layers in
layer order; ``decode_step`` writes both in place. The reference's
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
from repro_torch.models.multimodal import apply_frontend, frontend_t
from repro_torch.models.nn import (
    dense,
    dense_t,
    embed_lookup,
    embedding_t,
    init_params,
    rmsnorm,
    rmsnorm_t,
)
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.kernels.backend import resolve_device

__all__ = ["lm_template", "init_lm", "forward", "decode_step", "init_cache", "lm_loss"]


def lm_template(cfg: ModelConfig) -> Dict:
    t: Dict = {
        "embed": embedding_t(cfg.vocab_padded, cfg.d_model),
        "layers": [block_t(cfg, cfg.block_pattern[i % cfg.period])
                   for i in range(cfg.n_layers)],
        "final_norm": rmsnorm_t(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = dense_t(cfg.d_model, cfg.vocab_padded)
    fe = frontend_t(cfg)
    if fe:
        t["frontend"] = fe
    return t


def init_lm(seed: int, cfg: ModelConfig, *, device="cuda", trainable: bool = False) -> nn.Module:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default the
    card; raises without one), drawn from a ``torch.Generator`` on that
    device seeded with ``seed`` (where the reference takes a PRNG key);
    they require grad iff ``trainable``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(lm_template(cfg), gen, cfg.params_dtype(), device, trainable)


def _embed_inputs(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  feats: Optional[torch.Tensor]) -> torch.Tensor:
    """Frames (audio), patches prepended to the text (vision), or tokens."""
    if cfg.frontend != "none" and feats is None:
        raise ValueError(f"{cfg.name}: feats are required ({cfg.frontend} frontend)")
    if cfg.frontend != "audio" and tokens is None:
        raise ValueError(f"{cfg.name}: tokens are required")
    if cfg.frontend == "audio":
        return apply_frontend(params["frontend"], feats, cfg)
    h = embed_lookup(params["embed"], tokens, cfg.compute_dtype())
    if cfg.frontend == "vision":
        h = torch.cat([apply_frontend(params["frontend"], feats, cfg), h], dim=1)
    return h


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
        # Mask the padded vocabulary tail (never sampled). The reference
        # fills in float32 and casts back; filling in the logits' dtype
        # gives the same values (-1e30 takes one rounding either way)
        # without two float32 copies of the logits (19 GB at paligemma's
        # 4 x 2304 x 257,280).
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V], moe_aux scalar)."""
    h = _embed_inputs(params, cfg, tokens, feats)
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

def _attn_positions(cfg: ModelConfig):
    return [i for i in range(cfg.n_layers)
            if cfg.block_pattern[i % cfg.period].mixer == "attn"]


def _ssm_positions(cfg: ModelConfig):
    return [i for i in range(cfg.n_layers)
            if cfg.block_pattern[i % cfg.period].mixer == "ssm"]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device="cuda") -> Dict:
    """Decode cache on ``device``: the position (a Python int), the KV
    ring buffers of the attention layers (``"kv"``, compute dtype) and the
    SSM states and conv windows of the SSM layers (``"ssm"``), each only
    where the config has such layers."""
    return _new_cache(cfg, batch, max_seq, resolve_device(device))


def _new_cache(cfg: ModelConfig, batch: int, max_seq: int, device: torch.device) -> Dict:
    """:func:`init_cache` on any device, the meta device (the dry-run's)
    included."""
    dt = cfg.compute_dtype()
    cache: Dict = {"pos": 0}
    n_attn = len(_attn_positions(cfg))
    if n_attn:
        cache["kv"] = init_kv_cache(cfg, batch, max_seq, n_attn, dt, device)
    n_ssm = len(_ssm_positions(cfg))
    if n_ssm:
        cache["ssm"] = init_ssm_cache(cfg, batch, n_ssm, dt, device)
    return cache


def decode_step(
    params,
    cache: Dict,
    cfg: ModelConfig,
    token: torch.Tensor,  # [B, 1] int
) -> Tuple[torch.Tensor, Dict]:
    """One token of autoregressive decode. Returns (logits [B,1,V], cache).

    The returned cache holds the next position and the same tensors,
    written in place (the reference returns new arrays): each attention
    layer writes its KV slot, each SSM layer its state and conv window.
    Attention and SSM layers index their stacks by their own ordinals, as
    the reference's ``period_body`` does.
    """
    h = embed_lookup(params["embed"], token, cfg.compute_dtype())
    pos = int(cache["pos"])
    kv, ssm = cache.get("kv"), cache.get("ssm")
    ai = si = 0
    for i, layer in enumerate(params["layers"]):
        spec = cfg.block_pattern[i % cfg.period]
        if spec.mixer == "attn":
            h, _, _ = block_decode(layer, h, cfg, spec, pos, kv=(kv["k"][ai], kv["v"][ai]))
            ai += 1
        else:
            st = (ssm["state"][si], ssm["conv"][si])
            h, _, (state, conv) = block_decode(layer, h, cfg, spec, pos, ssm_state=st)
            st[0].copy_(state)
            st[1].copy_(conv)
            si += 1
    logits = _head(params, h, cfg)
    return logits, {**cache, "pos": pos + 1}


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
    """Cross-entropy LM loss, averaged over ``mask`` (all positions by
    default). Returns (loss + ``router_aux_weight`` * MoE aux, {"loss",
    "moe_aux"}).

    Decoder LMs: ``labels`` are next tokens (pre-shifted by the pipeline);
    with a vision frontend the loss covers the text positions only.
    Encoder (hubert): ``labels`` are per-frame targets, ``mask`` selects
    the masked-prediction positions.
    """
    logits, aux = forward(params, cfg, tokens=tokens, feats=feats)
    if cfg.frontend == "vision":
        logits = logits[:, cfg.num_patches:]
    nll = _token_nll(logits, labels)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "moe_aux": aux}
