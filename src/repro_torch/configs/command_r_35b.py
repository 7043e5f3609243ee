"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01]

The port's copy of ``repro.configs.command_r_35b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    block_pattern=(BlockSpec("attn", "mlp"),),
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=128, dtype="float32",
    )
