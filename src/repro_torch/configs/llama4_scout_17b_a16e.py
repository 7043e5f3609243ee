"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1. The brief's config applies MoE at every
layer (the HF release interleaves dense layers and adds a shared expert —
simplified per the assigned config; noted in DESIGN.md).
[hf:meta-llama/Llama-4-Scout-17B-16E]

The port's copy of ``repro.configs.llama4_scout_17b_a16e``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    block_pattern=(BlockSpec("attn", "moe"),),
    n_experts=16,
    top_k=1,
    d_ff_expert=8192,
    tie_embeddings=False,
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=64,
        d_ff_expert=64, n_experts=4, top_k=1, vocab=128, dtype="float32",
    )
