"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave.

Period-8 block: attention at position 4, Mamba elsewhere; MoE FF on odd
positions (every other layer), dense FF on even. SSD layers use
d_state=16 (Jamba v0.1 uses Mamba-1-style small state). long_500k RUNS:
attention layers' KV is sharded over the kv_seq axis and Mamba layers are
O(1)-state. [arXiv:2403.19887]

The port's copy of ``repro.configs.jamba_v01_52b``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

_P = (
    BlockSpec("ssm", "mlp"),
    BlockSpec("ssm", "moe"),
    BlockSpec("ssm", "mlp"),
    BlockSpec("ssm", "moe"),
    BlockSpec("attn", "mlp"),
    BlockSpec("ssm", "moe"),
    BlockSpec("ssm", "mlp"),
    BlockSpec("ssm", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    block_pattern=_P,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,  # 128 SSD heads
    tie_embeddings=False,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=8, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96,
        d_ff_expert=96, n_experts=4, top_k=2, ssm_state=8, ssm_head_dim=16,
        vocab=128, ssm_chunk=16, dtype="float32",
    )
