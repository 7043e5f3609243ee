"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, MoE 128 experts top-8 — the hot path for the paper's
technique: MoE dispatch = block-diagonal SpGEMM via the grouped kernel.
[hf:Qwen/Qwen3-30B-A3B]

The port's copy of ``repro.configs.qwen3_moe_30b_a3b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    block_pattern=(BlockSpec("attn", "moe"),),
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=32,
        d_ff_expert=32, n_experts=8, top_k=2, vocab=128, dtype="float32",
    )
