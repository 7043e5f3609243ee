"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional attention, w2v2 arch); masked-prediction
training over a 504-entry codebook. The CNN feature extractor is a stub —
``input_specs`` feeds precomputed 512-d conv-feature frames.
[arXiv:2106.07447]

The port's copy of ``repro.configs.hubert_xlarge``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    block_pattern=(BlockSpec("attn", "mlp"),),
    causal=False,  # encoder-only: no decode shapes
    act="gelu",
    mlp_gated=False,
    attn_bias=True,
    tie_embeddings=True,  # codebook table doubles as prediction head
    frontend="audio",
    frontend_dim=512,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        frontend_dim=32, dtype="float32",
    )
