"""Optimizer pieces of the training step, the port of ``repro.optim``:
AdamW with an optional float32 master copy (``adamw``), global-norm
clipping (``clip``), learning-rate schedules (``schedules``) and int8
error-feedback gradient compression (``compress``).

``repro.optim.zero`` has no counterpart: it is ZeRO-1 as a table of
sharding constraints that splits the optimizer state over the mesh's data
axes, and one card has no data axis.
"""
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["AdamW", "clip_by_global_norm", "constant", "global_norm", "warmup_cosine"]
