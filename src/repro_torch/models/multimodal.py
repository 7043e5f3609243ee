"""Modality frontend stubs: the port of ``repro.models.multimodal``.

The ``[audio]`` / ``[vlm]`` configs specify the transformer backbone only;
the inputs are precomputed frame or patch embeddings.

* audio  (hubert):    [B, S, frontend_dim] conv-feature frames -> linear
  projection to d_model (the CNN feature extractor itself is out of scope).
* vision (paligemma): [B, num_patches, frontend_dim] SigLIP patch embeddings
  -> linear projection, prepended to the text-token embeddings.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import dense, dense_t

__all__ = ["frontend_t", "apply_frontend"]


def frontend_t(cfg: ModelConfig) -> Dict:
    if cfg.frontend == "none":
        return {}
    return {"proj": dense_t(cfg.frontend_dim, cfg.d_model, bias=True)}


def apply_frontend(p, feats: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """feats: [B, S_frames|N_patches, frontend_dim] -> [B, *, d_model]."""
    return dense(p["proj"], feats.to(cfg.compute_dtype()))
