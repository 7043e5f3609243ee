"""Prefill and decode step builders.

The port of the serving half of ``repro.runtime.steps``. The returned
functions run eagerly under ``torch.no_grad``; the reference's jit and
sharding have no counterpart on one card. The train step comes with the
training slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig):
    """Forward over the full prompt; returns last-position logits."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = tr.forward(params, cfg, tokens=batch.get("tokens"),
                               feats=batch.get("feats"))
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, cache, token):
        return tr.decode_step(params, cache, cfg, token)

    return decode_step
