"""Flash attention kernel: the wrapper of ``csrc/flash_attention.cu``.

The port of ``repro.kernels.flash_attention`` (the TPU kernel K5).
Online-softmax attention over ``[BH, S, D]`` with causal masking, a
sliding window and a ``q_offset`` (chunked prefill against a longer kv
sequence); rows that see no key give 0. Each thread block owns one (bh,
q tile) and loops over kv tiles of 64 keys, skipping tiles that the
causal diagonal or the window masks wholly.

The kernel is chosen by the operands' type, a static rule with no
fallback. Float32 runs on float32 FMAs over 64-row q tiles (float32
parity rules out TF32). Bfloat16 runs on the tensor cores (``mma.sync``)
over 128-row q tiles, with K and V double-buffered by ``cp.async``; it
multiplies P by V as two bf16 halves (hi + lo) of the float32
probabilities, so that the output stays within the float32 result's
tolerance. The tiles are the kernels' own, so they match the TPU kernel
within tolerance, not bit for bit; the reference's ``bq``, ``bk`` and
``interpret`` options have no counterpart.

:func:`flash_attention` launches a kernel for CUDA tensors and raises on
anything it does not accept (D above 256 or not a multiple of 8, mixed
devices or types, non-contiguous or misshapen operands). For CPU tensors
it computes the same result with the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`. Its ``launches``
attribute counts kernel launches, ``bf16_launches`` those of the
tensor-core kernel among them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_flash_attention

__all__ = ["flash_attention"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_LIMIT = 1 << 30


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [BH, S, D], got {tuple(t.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q ({q.device}), k ({k.device}) and v ({v.device}) must be on one device"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"mismatched shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def _launch(q, k, v, causal, window, q_offset, scale) -> torch.Tensor:
    bh, sq, d = (int(x) for x in q.shape)
    skv = int(k.shape[1])
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the CUDA kernel takes q, k, v all float32 or all bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"the CUDA kernel takes D a multiple of 8 up to 256; D={d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    q_last = sq - 1 + q_offset
    if max(bh, sq, skv, abs(q_offset), abs(q_last)) >= _INT_LIMIT:
        raise ValueError("sizes and q_offset must stay below 2**30")
    has_window = window is not None
    # A window wider than the last query position masks nothing; clamping
    # it keeps qi - window inside int32 in the kernel.
    win = 0 if not has_window else max(min(int(window), max(q_last, 0) + 1), -_INT_LIMIT)
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    lib = load_flash_attention()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], bh, sq, skv, d, float(scale), int(bool(causal)),
            int(has_window), win, int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    flash_attention.bf16_launches += int(q.dtype == torch.bfloat16)
    return out


def flash_attention(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Skv, D]
    v: torch.Tensor,  # [BH, Skv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``q`` over ``k``, ``v``; ``scale`` defaults to
    1/sqrt(D). Returns ``[BH, Sq, D]`` in q's dtype."""
    _check(q, k, v)
    scale_val = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale_val
        ).to(q.dtype)
    return _launch(q, k, v, causal, window, q_offset, scale_val)


flash_attention.launches = 0
flash_attention.bf16_launches = 0
