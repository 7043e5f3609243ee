"""Architecture registry + the assigned input-shape grid.

The port of ``repro.configs.registry``: the same ten architectures in the
same order, the same shapes, and the same applicability verdict per
(arch x shape) cell:

* encoder-only archs (hubert) have no decode step -> decode shapes skipped;
* ``long_500k`` needs sub-quadratic attention -> runs only for SSM / SWA /
  hybrid archs, skipped (documented) for pure full-attention archs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "get_reduced",
           "cells", "cell_status"]

ARCHS: Dict[str, str] = {
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).reduced()


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs, reason) for one (arch, shape) cell."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 500k-token decode needs "
            "sub-quadratic attention (documented skip)"
        )
    return True, "runs"


def cells() -> List[Tuple[str, str, bool, str]]:
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            runs, reason = cell_status(cfg, shape)
            out.append((arch, shape.name, runs, reason))
    return out
