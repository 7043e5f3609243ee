"""Fault-tolerant checkpoints of trees of tensors (``manager``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
