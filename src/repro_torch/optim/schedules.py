"""Learning-rate schedules: pure functions of the step (a Python int or an
integer tensor) returning a float32 0-d tensor on the CPU, computed in
float32 as the reference computes them."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine"]


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return f
