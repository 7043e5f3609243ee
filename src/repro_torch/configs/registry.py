"""Architecture registry of the port.

It lists only the architectures the port runs: text models whose blocks
(attention with an MLP or an MoE) are ported. Of the eight more that the
reference registry (``repro.configs.registry``) lists, four need only
their config files (command-r-35b, yi-9b, h2o-danube-3-4b and the MoE
llama4-scout-17b-a16e) and four wait for the SSM or frontend modules
(mamba2-130m, jamba-v0.1-52b, hubert-xlarge, paligemma-3b).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "get_reduced"]

ARCHS: Dict[str, str] = {
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(
            f"architecture {arch!r} is not ported yet; the port runs {sorted(ARCHS)}"
        )
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
