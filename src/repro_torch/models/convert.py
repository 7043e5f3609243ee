"""Carry the JAX package's LM parameters into the port.

:func:`params_from_jax` takes the reference's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``: nested dicts and lists, no
JAX types) and returns the port's parameter modules holding the same
values, so that both packages compute with the same weights. The
reference stacks each pattern position's layers along a leading period
axis (``_stack_template``); layer ``i`` of the port is period
``i // period`` of pattern position ``i % period``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Param, ParamTree
from repro_torch.models.transformer import lm_template
from repro_torch.kernels.backend import resolve_device

__all__ = ["params_from_jax"]


def _fill(template: Any, tree: Any, path: str, period, n_periods: int, dtype, device,
          trainable: bool):
    """Fill ``template`` from ``tree``. With ``period`` set, every leaf of
    ``tree`` is stacked over ``n_periods`` and the port takes that row."""
    if isinstance(template, Param):
        if isinstance(tree, (dict, list, tuple)):
            raise ValueError(f"{path}: expected an array, got a {type(tree).__name__}")
        arr = np.asarray(tree)
        want = tuple(template.shape) if period is None else (n_periods, *template.shape)
        if arr.shape != want:
            raise ValueError(f"{path}: shape {arr.shape}, expected {want}")
        if period is not None:
            arr = arr[period]
        # float32 first: numpy has no bfloat16 of its own.
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device, dtype)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: expected a dict, got {type(tree).__name__}")
    missing = sorted(set(template) - set(tree))
    extra = sorted(set(tree) - set(template))
    if missing or extra:
        raise ValueError(f"{path}: missing leaves {missing}, unexpected leaves {extra}")
    return ParamTree({k: _fill(template[k], tree[k], f"{path}/{k}", period, n_periods,
                               dtype, device, trainable)
                      for k in template}, trainable)


def params_from_jax(tree: Any, cfg: ModelConfig, device="cuda",
                    trainable: bool = False) -> nn.Module:
    """The port's parameters for ``cfg`` from the reference's tree (numpy
    leaves), in ``cfg.param_dtype`` on ``device``, requiring grad iff
    ``trainable``. Raises on any missing, extra or misshapen leaf."""
    device = resolve_device(device)
    dtype = cfg.params_dtype()
    template = lm_template(cfg)
    stacks = tree.get("layers") if isinstance(tree, dict) else None
    if not isinstance(stacks, (list, tuple)) or len(stacks) != cfg.period:
        raise ValueError(f"layers: expected a list of {cfg.period} stacked pattern positions")
    out = {}
    for key, t in template.items():
        if key == "layers":
            out[key] = nn.ModuleList([
                _fill(layer_t, stacks[i % cfg.period], f"layers[{i % cfg.period}]",
                      i // cfg.period, cfg.n_periods, dtype, device, trainable)
                for i, layer_t in enumerate(t)
            ])
        elif key not in tree:
            raise ValueError(f"missing leaves ['{key}']")
        else:
            out[key] = _fill(t, tree[key], key, None, cfg.n_periods, dtype, device, trainable)
    extra = sorted(set(tree) - set(template))
    if extra:
        raise ValueError(f"unexpected leaves {extra}")
    return ParamTree(out)
