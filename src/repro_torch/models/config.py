"""Model configuration: the port of ``repro.models.config``.

The same fields, defaults and derived counts as the reference. Two things
differ: :meth:`ModelConfig.compute_dtype` and :meth:`ModelConfig.params_dtype`
return torch dtypes, and ``kernel_backend`` takes the port's backend names
(``"auto"``, ``"cuda"``, ``"torch"``, resolved per device as
:func:`repro_torch.kernels.backend.resolve_backend` does).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "BlockSpec"]


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position in the repeating layer pattern."""

    mixer: str  # "attn" | "ssm"
    ff: str  # "mlp" | "moe" | "none" (pure-mixer layers, e.g. Mamba stacks)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # Layer composition: the pattern repeats n_layers / len(pattern) times.
    block_pattern: Tuple[BlockSpec, ...] = (BlockSpec("attn", "mlp"),)
    d_head: Optional[int] = None  # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0  # expert hidden dim (d_ff used if 0)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0  # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # --- attention flavour ---
    window: Optional[int] = None  # sliding-window attention
    rope_theta: float = 10_000.0
    causal: bool = True  # False for encoder-only archs
    # --- embeddings / head ---
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None
    # --- frontend stubs (audio / vision) ---
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0  # precomputed frame/patch embedding width
    num_patches: int = 0  # vision prefix length inside seq
    # --- MLP flavour ---
    act: str = "silu"
    mlp_gated: bool = True
    attn_bias: bool = False
    # --- sparse-weight feature (the paper's technique on FFN weights) ---
    sparse_ffn: bool = False
    sparse_block: int = 128
    sparse_density: float = 0.25
    # --- numerics / execution ---
    vocab_pad_multiple: int = 128  # pad embed/head so the vocab TP-shards
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation/param compute dtype
    param_dtype: str = "float32"
    remat: str = "full"  # none | full | dots
    attn_impl: str = "dense"  # dense | blocked (per-shape override)
    attn_block_q: int = 1024
    scan_unroll: bool = False  # unroll the layer loop (cost sub-compiles)
    kernel_backend: str = "auto"  # auto | cuda | torch

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.block_pattern)}"
            )

    # -- derived ---------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return any(b.mixer == "attn" for b in self.block_pattern)

    @property
    def has_ssm(self) -> bool:
        return any(b.mixer == "ssm" for b in self.block_pattern)

    @property
    def has_moe(self) -> bool:
        return any(b.ff == "moe" for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if 500k-token decode is serveable: attention is window-
        bounded or absent, or the arch is a hybrid (SSM layers are O(1)-
        state and the few attention layers' KV shards over kv_seq)."""
        return (not self.has_attention) or (self.window is not None) \
            or self.has_ssm

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_ff(self) -> int:
        return self.d_ff_expert if self.d_ff_expert else self.d_ff

    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    def params_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for 6ND model FLOPs) ---------------------------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.head_dim
        attn = (
            d * self.n_heads * hd  # Wq
            + 2 * d * self.n_kv_heads * hd  # Wk, Wv
            + self.n_heads * hd * d  # Wo
        )
        ff_table = {"none": 0}
        mlp = (3 if self.mlp_gated else 2) * d * self.d_ff
        moe = self.n_experts * (3 if self.mlp_gated else 2) * d * self.expert_ff \
            + d * self.n_experts
        moe_active = self.top_k * (3 if self.mlp_gated else 2) * d * self.expert_ff \
            + d * self.n_experts
        di, n_state, h = self.d_inner, self.ssm_state, self.ssm_heads
        ssm = (
            d * (2 * di + 2 * n_state + h)  # in_proj (z,x,B,C,dt)
            + self.ssm_conv_width * (di + 2 * n_state)  # conv
            + 3 * h  # A_log, D, dt_bias
            + di  # gated norm
            + di * d  # out_proj
        )
        total = active = 0
        for li in range(self.n_layers):
            b = self.block_pattern[li % self.period]
            mix = attn if b.mixer == "attn" else ssm
            ff = ff_table.get(b.ff, mlp if b.ff == "mlp" else moe)
            ff_a = ff_table.get(b.ff, mlp if b.ff == "mlp" else moe_active)
            norms = 2 * d
            total += mix + ff + norms
            active += mix + ff_a + norms
        embed = self.vocab * d
        head = 0 if self.tie_embeddings else d * self.vocab
        total += embed + head + d
        active += embed + head + d
        return {"total": total, "active": active, "embed": embed}
