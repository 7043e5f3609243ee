"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention (window 4096),
which makes 500k-token decode serveable (window-bounded KV ring buffer).
[arXiv:2401.16818]

The port's copy of ``repro.configs.h2o_danube_3_4b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    block_pattern=(BlockSpec("attn", "mlp"),),
    window=4096,  # SWA
    tie_embeddings=False,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=128, window=32, dtype="float32",
    )
