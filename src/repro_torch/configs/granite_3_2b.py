"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA, tied embeddings. [hf:ibm-granite/granite-3.0-2b-base]

The port's copy of ``repro.configs.granite_3_2b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    block_pattern=(BlockSpec("attn", "mlp"),),
    tie_embeddings=True,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=131, dtype="float32",
    )
