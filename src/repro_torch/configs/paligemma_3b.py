"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma backbone. The SigLIP tower is a stub:
``input_specs`` provides 256 precomputed 1152-d patch embeddings that a
linear connector projects and prepends to the text tokens.
[arXiv:2407.07726]

The port's copy of ``repro.configs.paligemma_3b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    d_head=256,  # gemma head_dim
    block_pattern=(BlockSpec("attn", "mlp"),),
    act="gelu",
    mlp_gated=True,  # gemma geglu
    tie_embeddings=True,
    frontend="vision",
    frontend_dim=1152,
    num_patches=256,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab=128, frontend_dim=48, num_patches=8,
        dtype="float32",
    )
