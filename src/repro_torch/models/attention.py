"""GQA/MQA attention with RoPE, sliding windows and a KV cache.

The port of ``repro.models.attention``. Full-sequence attention
(:func:`attn_forward`) has the reference's three plans, chosen by the same
rules:

* the flash kernel (:func:`repro_torch.kernels.ops.attention`) for every
  prefill on the card, at any sequence length, with (B, KV, R) flattened
  into the kernel's BH axis and k, v repeated R times, as the reference
  does. On CPU tensors the branch is chosen by the reference's rule: the
  kernel entry point (its plain version, there) when ``kernel_backend``
  resolves to ``"cuda"`` and the length is a multiple of 512, the TPU
  kernel's tile. The meta device (the dry-run's count) takes the card's
  branch;
* ``blocked``: a loop over query blocks, each attending to the full KV;
* ``dense``: the full [Sq, Skv] score matrix.

The last two are plain torch, as the reference left them to XLA. Where the
reference multiplies bf16 operands with a float32 result
(``preferred_element_type``), the port upcasts to float32 first, so the
products are exact and the sums are taken in float32 as there.

Decode attends one new token against the cache with a dense score row,
scaled by ``/ sqrt(hd)`` as in the reference. The reference's sharding
annotations have no counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_backend
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Param, dense, dense_t

__all__ = ["attn_t", "attn_forward", "attn_decode", "init_kv_cache", "rope"]

_NEG_INF = -1e30
# The reference's gate: its TPU kernel's 512-row tiles. The CUDA kernel
# takes any length, so the gate only picks the branch for CPU tensors,
# where the parity tests hold each branch against the reference's.
_FLASH_SEQ_MULTIPLE = 512


def attn_t(cfg: ModelConfig) -> Dict:
    hd = cfg.head_dim
    return {
        "wq": dense_t(cfg.d_model, (cfg.n_heads, hd), bias=cfg.attn_bias),
        "wk": dense_t(cfg.d_model, (cfg.n_kv_heads, hd), bias=cfg.attn_bias),
        "wv": dense_t(cfg.d_model, (cfg.n_kv_heads, hd), bias=cfg.attn_bias),
        "wo": {"w": Param((cfg.n_heads, hd, cfg.d_model))},
    }


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis. x: [B, S, H, D], positions [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half: 2 * half].float()
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if d % 2:
        rot = torch.cat([rot, x[..., 2 * half:].float()], dim=-1)
    return rot.to(x.dtype)


def _mask(
    q_pos: torch.Tensor,  # [Sq] absolute positions of queries
    k_pos: torch.Tensor,  # [Skv]
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _gqa_scores_apply(
    q: torch.Tensor,  # [B, Sq, KV, R, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,  # [B, Skv, KV, hd]
    mask: torch.Tensor,  # [Sq, Skv] bool
    scale: float,
) -> torch.Tensor:
    """Masked softmax attention in float32; the probabilities drop to v's
    dtype before the PV product, as in the reference. Returns float32
    [B, Sq, KV, R, hd]."""
    s = torch.einsum("bqkrd,bskd->bkrqs", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[None, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[None, None, None, :, None], p, 0.0)
    return torch.einsum("bkrqs,bskd->bqkrd", p.to(v.dtype).float(), v.float())


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    q = dense(p["wq"], x)  # [B, S, H, hd]
    k = dense(p["wk"], x)  # [B, S, KV, hd]
    v = dense(p["wv"], x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum("bshd,hde->bse") in x's dtype, as one matrix product."""
    w = p["wo"]["w"].to(x.dtype)
    b, s, h, hd = out.shape
    return (out.reshape(b, s, h * hd) @ w.reshape(h * hd, -1)).reshape(b, s, -1)


def attn_forward(
    p,
    x: torch.Tensor,  # [B, S, D]
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    kv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, kv, rep, hd)

    backend = resolve_backend(cfg.kernel_backend, x.device)
    if backend == "cuda" and (x.device.type in ("cuda", "meta") or s % _FLASH_SEQ_MULTIPLE == 0):
        # Flash kernel path: flatten (B, KV, R) into the BH axis. The kernel
        # takes contiguous operands; at B = 1 the reshape of q is a strided
        # view, not a copy.
        qf = qg.permute(0, 2, 3, 1, 4).reshape(b * kv * rep, s, hd).contiguous()
        kf = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(b * kv * rep, s, hd)
        vf = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(b * kv * rep, s, hd)
        of = kops.attention(qf, kf, vf, cfg.causal, cfg.window, 0, cfg.kernel_backend)
        out = of.reshape(b, kv, rep, s, hd).permute(0, 3, 1, 2, 4)
    elif cfg.attn_impl == "blocked" and s > cfg.attn_block_q and s % cfg.attn_block_q == 0:
        bq = cfg.attn_block_q
        k_pos = positions[0]
        blocks = []
        for i in range(s // bq):
            m = _mask(positions[0, i * bq:(i + 1) * bq], k_pos, cfg.causal, cfg.window)
            blocks.append(_gqa_scores_apply(qg[:, i * bq:(i + 1) * bq], k, v, m, scale))
        out = torch.cat(blocks, dim=1)
    else:
        m = _mask(positions[0], positions[0], cfg.causal, cfg.window)
        out = _gqa_scores_apply(qg, k, v, m, scale)

    out = out.reshape(b, s, cfg.n_heads, hd).to(x.dtype)
    return _out_proj(p, out, x)


# ---------------------------------------------------------------------------
# KV cache / decode
# ---------------------------------------------------------------------------

def init_kv_cache(
    cfg: ModelConfig, batch: int, max_seq: int, n_attn_layers: int, dtype, device
) -> Dict[str, torch.Tensor]:
    """Cache stacked over attention-layer instances. For SWA archs the
    cache is a ring buffer of ``window`` slots."""
    s = min(max_seq, cfg.window) if cfg.window else max_seq
    shape = (n_attn_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_decode(
    p,
    x: torch.Tensor,  # [B, 1, D]
    cache_k: torch.Tensor,  # [B, S_cache, KV, hd]
    cache_v: torch.Tensor,
    pos: int,  # absolute position of the new token
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step vs the cache. Returns (y, cache_k, cache_v).

    The new key and value are written into the cache in place, at the
    token's slot (its ring-buffer slot for SWA caches). The reference
    writes with a one-hot masked select over all slots instead, for the
    sake of its sequence-sharded cache; both give the same cache, and
    both write nothing when the position lies past the last slot of a
    cache without a window.
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    slot = pos % s_cache if cfg.window else pos
    if 0 <= slot < s_cache:
        cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)

    kv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    qg = q.reshape(b, 1, kv, rep, hd)
    # Validity of cache slots: slot index positions vs current pos.
    idx = torch.arange(s_cache, device=x.device)
    if cfg.window:
        # Ring buffer: slot i holds absolute position p_i = i (mod s_cache)
        # with p_i <= pos; valid iff pos - p_i < window and p_i <= pos.
        age = (slot - idx) % s_cache  # 0 = newest
        valid = age < min(pos + 1, cfg.window)
    else:
        valid = idx <= pos
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.float()) / math.sqrt(hd)
    s = s.masked_fill(~valid[None, None, None, None, :], _NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", pr.to(cache_v.dtype).float(), cache_v.float())
    out = out.reshape(b, 1, cfg.n_heads, hd).to(x.dtype)
    return _out_proj(p, out, x), cache_k, cache_v
