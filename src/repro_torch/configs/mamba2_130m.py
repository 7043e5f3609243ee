"""mamba2-130m [ssm]: 24L d_model=768, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality), pure mixer layers (no FF).
The paper's SpGEMM technique is inapplicable to the dense SSD recurrence
(DESIGN.md §Arch-applicability); the arch is implemented without it.
long_500k runs (O(1)-state decode). [arXiv:2405.21060]

The port's copy of ``repro.configs.mamba2_130m``: the same published
widths and the same ``reduced()`` test size.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    block_pattern=(BlockSpec("ssm", "none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,  # 24 SSD heads
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
        vocab=128, ssm_chunk=16, dtype="float32",
    )
