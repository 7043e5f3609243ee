"""Architecture registry of the port.

It lists only the architectures the port can run: their blocks (attention
and MLP) are ported. The reference registry (``repro.configs.registry``)
lists nine more, which wait for the MoE, SSM and vision modules.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "get_reduced"]

ARCHS: Dict[str, str] = {
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
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
