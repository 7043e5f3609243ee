"""Device and backend policy shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU:
:func:`resolve_device` turns ``"cuda"`` (the default) into a concrete CUDA
device and raises without one. :func:`resolve_backend` picks between a
hand-written kernel (``"cuda"``) and its plain PyTorch version
(``"torch"``); the plain version never runs on a CUDA device.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_backend", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) needs a
    CUDA device and raises without one; there is no fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch version"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_backend(backend: str = "auto", device="cpu") -> str:
    """``"cuda"`` is the hand-written kernel, ``"torch"`` its plain
    version; ``"auto"`` takes the kernel on a CUDA device and the plain
    version on the CPU. The plain version never runs on a CUDA device."""
    device = torch.device(device)
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "torch" and device.type == "cuda":
        raise ValueError(
            "backend 'torch' is the plain CPU version; on a CUDA device "
            "the hand-written kernel runs (backend 'cuda' or 'auto')"
        )
    return backend
