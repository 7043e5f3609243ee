"""Grouped (expert) matmul kernel: the wrapper of ``csrc/moe_gmm.cu``.

The port of ``repro.kernels.moe_gmm`` (the TPU kernel K4): tokens sorted by
expert, in tiles of ``tm`` rows that each belong to one expert, times that
expert's weight, ``out[tile i] = x[tile i] @ w[tile_expert[i]]``, summed in
float32 over the whole of D.

The kernel is chosen by the operands' type, a static rule with no
fallback. Float32 runs on float32 FMAs (float32 parity rules out TF32):
one thread block per (row tile, 128-column tile), looping over D.
Bfloat16 runs on the tensor cores: wgmma on tiles that TMA streams
through shared memory, computing the transposed product so that the
tile's tokens are wgmma's N; TMA needs w's rows padded to a multiple of 8
values, so for F % 8 != 0 this wrapper pads a copy of w (no model shape
does). Either kernel's row tile is the largest of 128, 64, 32, 16, 8 that
divides ``tm``, so it never straddles two experts. The reference's ``bd``
and ``bf`` are the TPU kernel's VMEM block sizes and have no counterpart:
the CUDA kernels' tiles are their own and change the result only by
summation order. Nor has ``interpret``.

:func:`moe_gmm` launches a kernel for CUDA tensors and raises on anything
it does not accept. For CPU tensors it computes the same result with the
plain version, :func:`repro_torch.kernels.ref.moe_gmm_ref`. Its
``launches`` attribute counts kernel launches, ``bf16_launches`` those of
the tensor-core kernel among them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_moe_gmm

__all__ = ["moe_gmm"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_LIMIT = 1 << 31


def _tile_expert(tile_expert, n_tiles: int, n_experts: int, device) -> torch.Tensor:
    """``tile_expert`` as int32 on ``device``. One handed over from the host
    (numpy, a list or a CPU tensor) is checked here; one already on the
    card is taken as it is (checking it would wait for the card), and the
    kernel writes NaN rows for an expert outside [0, E)."""
    on_card = isinstance(tile_expert, torch.Tensor) and tile_expert.device.type == "cuda"
    if on_card:
        te = tile_expert
    else:
        host = tile_expert.numpy() if isinstance(tile_expert, torch.Tensor) else tile_expert
        host = np.asarray(host)
        if not np.issubdtype(host.dtype, np.integer):
            raise TypeError("tile_expert must hold integers")
        if host.size and (host.min() < 0 or host.max() >= n_experts):
            raise ValueError(f"tile_expert holds experts outside [0, {n_experts})")
        te = torch.from_numpy(host.astype(np.int32))
    if tuple(te.shape) != (n_tiles,):
        raise ValueError(f"tile_expert must be [{n_tiles}] (one expert per tile), "
                         f"got {tuple(te.shape)}")
    return te.to(device=device, dtype=torch.int32).contiguous()


def _launch(x, w, te: torch.Tensor, tm: int) -> torch.Tensor:
    t, d = (int(s) for s in x.shape)
    e, _, f = (int(s) for s in w.shape)
    if tm % 8:
        raise ValueError(f"the CUDA kernel takes tm a multiple of 8; tm={tm}")
    if d % 16 or f % 4:
        raise ValueError(f"the CUDA kernel takes D a multiple of 16 and F a multiple of 4; "
                         f"D={d}, F={f}")
    if max(t, d, f, e) >= _INT_LIMIT:
        raise ValueError("sizes must stay below 2**31")
    for name, a in (("x", x), ("w", w)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((t, f), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    if x.dtype == torch.bfloat16 and f % 8:
        # TMA reads w through 16-byte row strides: pad its rows to 8 values.
        w = torch.nn.functional.pad(w, (0, 8 - f % 8))
    lib = load_moe_gmm()
    with torch.cuda.device(x.device):
        err = lib.moe_gmm_launch(
            x.data_ptr(), w.data_ptr(), te.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            t, d, f, e, tm, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError_t {err}")
    moe_gmm.launches += 1
    moe_gmm.bf16_launches += int(x.dtype == torch.bfloat16)
    return out


def moe_gmm(
    x: torch.Tensor,  # [T, D] tokens sorted by expert, T % tm == 0
    w: torch.Tensor,  # [E, D, F] expert weights
    tile_expert,  # [T // tm] int expert of each token tile
    *,
    tm: int = 128,
) -> torch.Tensor:
    """Grouped matmul; returns [T, F] float32 (the reference's default
    ``out_dtype``, which no caller changes)."""
    if not isinstance(x, torch.Tensor) or not isinstance(w, torch.Tensor):
        raise TypeError("x and w must be torch tensors")
    if x.device != w.device:
        raise ValueError(f"x ({x.device}) and w ({w.device}) must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x must be [T, D] and w [E, D, F]; got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    t = int(x.shape[0])
    if tm < 1 or t % tm:
        raise ValueError(f"T={t} must be a multiple of tm={tm}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    te = _tile_expert(tile_expert, t // tm, int(w.shape[0]), x.device)
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w, te, tm)
    return _launch(x, w, te, tm)


moe_gmm.launches = 0
moe_gmm.bf16_launches = 0
