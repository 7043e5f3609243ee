"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA, untied embeddings. [arXiv:2403.04652]

The port's copy of ``repro.configs.yi_9b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    block_pattern=(BlockSpec("attn", "mlp"),),
    tie_embeddings=False,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=128, dtype="float32",
    )
