"""Public entry points over the kernels, the port of ``repro.kernels.ops``.

* ``spgemm``: sparse x sparse, a shim over the plan/execute API through
  the plan cache (K1);
* ``sparse_dense_matmul``: dense activations x a block-sparse weight
  (K3, the SparseLinear forward);
* ``grouped_matmul``: the MoE expert compute over expert-sorted tokens
  (K4);
* ``attention``: prefill attention (the flash kernel, K5), with the
  reference's recompute backward.

Each takes ``backend`` as :func:`repro_torch.kernels.backend.resolve_backend`
checks it and runs where its tensors lie: the kernel for CUDA tensors, its
plain version for CPU tensors (``spgemm`` takes ``device``, since its
inputs are host arrays).

Gradients: ``attention`` has the reference's custom VJP, a recompute
through the plain version. The reference gives K3 and K4 no VJP (its MoE
and SparseLinear train through ``jnp`` products), and their launches here
write a fresh tensor outside autograd, so ``sparse_dense_matmul`` and
``grouped_matmul`` refuse CUDA inputs that require grad rather than drop
the gradient without a word. The MoE layer trains on the card all the
same: ``repro_torch.models.moe`` calls ``grouped_matmul`` inside its own
autograd Function, whose backward is two more ``grouped_matmul`` calls in
the expert-blocked layout that only it knows (a tile order of a direct
call has no such dw). K3's gradient on the card stays refused. On CPU
tensors the plain versions are differentiable.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import SpGEMMSchedule
from repro_torch.kernels import ref
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.bsr_spmm import bsr_spmm, plan_bsr
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.sparse.formats import BCSR, BCSV, CSR
from repro_torch.spgemm.cache import PlanCache
from repro_torch.spgemm.plan import SpGEMMPlan, spgemm_plan

__all__ = ["attention", "grouped_matmul", "sparse_dense_matmul", "spgemm"]


def spgemm(
    a: BCSV,
    b: BCSR,
    *,
    backend: str = "auto",
    device="cuda",
    schedule: Optional[SpGEMMSchedule] = None,
    cache: Optional[PlanCache] = None,
) -> CSR:
    """C = A @ B for block-sparse A (BCSV) and B (BCSR).

    Thin shim over :mod:`repro_torch.spgemm`: builds — or fetches from the
    plan cache (process-level by default; pass ``cache`` to isolate) — an
    :class:`SpGEMMPlan` for this sparsity pattern and runs its numeric
    phase with the given values. A ``schedule`` from the caller's own
    symbolic phase is honored without caching. Callers that reuse one
    pattern should hold a plan (``spgemm_plan``) instead.

    The returned CSR has C's *structural* pattern (every element of every
    structurally nonzero C block): elements that compute to exact zero are
    stored explicitly.
    """
    if schedule is not None:
        plan = SpGEMMPlan.from_blocks(
            a, b, backend=backend, device=device, schedule=schedule
        )
        return plan.execute()
    plan = spgemm_plan(a, b, backend=backend, device=device, cache=cache)
    try:
        # Values passed explicitly make the rebind and the launch one step
        # under the plan's lock, even when the cached plan is shared
        # across threads.
        return plan.execute(a.blocks, b.blocks)
    finally:
        # One-shot use: free the device copies (the scarce resource) but
        # keep the host values staged, since the plan is shared with any
        # direct spgemm_plan holder of this pattern, whose no-arg
        # execute() must keep working.
        plan.release_device_values()


def _refuse_grad_on_card(what: str, *tensors: torch.Tensor) -> None:
    """Raise for CUDA operands that require grad: the kernel's launch
    writes its output outside autograd, so they would get no gradient."""
    if tensors[0].device.type == "cuda" and torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors
    ):
        raise NotImplementedError(
            f"{what} has no backward on the card: its kernel's output would carry no "
            "gradient to its operands (MoE training on the card goes through "
            "repro_torch.models.moe, whose expert matmuls carry their own backward)"
        )


def _bsr_operands(w: BCSV) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """W's blocks in the SpMM kernel's order, with every column panel
    covered: (blocks, brow, bcol, flags), host arrays.

    W is stored row-group-major (BCSV over K); the kernel wants
    column-panel-major (:func:`plan_bsr`), and a zero block at block-row 0
    for every column panel that has none, re-sorted into place, since the
    reference's kernel never writes a panel it does not visit.
    """
    bk, bn = w.block_shape
    n = w.shape[1]
    order, brow, bcol, flags = plan_bsr(w.brow, w.bcol)
    blocks = w.blocks[order]
    present = np.zeros(n // bn, bool)
    present[bcol] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size:
        blocks = np.concatenate(
            [blocks, np.zeros((missing.size, bk, bn), blocks.dtype)]
        )
        brow = np.concatenate([brow, np.zeros(missing.size, np.int32)])
        bcol = np.concatenate([bcol, missing])
        flags = np.concatenate([flags, np.full(missing.size, 3, np.int32)])
        order2 = np.lexsort((brow, bcol))
        blocks, brow, bcol, flags = (
            blocks[order2], brow[order2], bcol[order2], flags[order2]
        )
    return blocks, brow, bcol, flags


def sparse_dense_matmul(
    x: torch.Tensor,  # [M, K]
    w: BCSV,  # [K, N] block-sparse weight
    *,
    backend: str = "auto",
    tm: int = 128,
) -> torch.Tensor:
    """y = x @ W with W block-sparse (zero column panels handled); returns
    [M, N] float32.

    W's blocks (host numpy) go to x's device in x's dtype; M is padded to
    a multiple of ``tm`` for the kernel and the padding sliced off. A CUDA
    ``x`` that requires grad is refused (see the module docstring).
    """
    resolve_backend(backend, x.device)
    _refuse_grad_on_card("sparse_dense_matmul (K3)", x)
    k, n = w.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be [M, {k}], got {tuple(x.shape)}")
    blocks, brow, bcol, flags = _bsr_operands(w)
    m = int(x.shape[0])
    pad_m = (-m) % tm
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad_m)) if pad_m else x
    y = bsr_spmm(xp.contiguous(), torch.from_numpy(blocks).to(x.device, x.dtype),
                 brow, bcol, flags, n=n, tm=tm)
    return y[:m] if pad_m else y


def grouped_matmul(
    x: torch.Tensor,  # [T, D] tokens sorted by expert (padded per expert)
    w: torch.Tensor,  # [E, D, F]
    tile_expert,  # [T // tm]
    *,
    tm: int = 128,
    backend: str = "auto",
) -> torch.Tensor:
    """out[tile i] = x[tile i] @ w[tile_expert[i]] over ``tm``-row tiles;
    returns [T, F] float32 (:func:`moe_gmm`). CUDA operands that require
    grad are refused (see the module docstring)."""
    resolve_backend(backend, x.device)
    _refuse_grad_on_card("grouped_matmul (K4)", x, w)
    return moe_gmm(x, w, tile_expert, tm=tm)


def attention(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Skv, D]
    v: torch.Tensor,  # [BH, Skv, D]
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    backend: str = "auto",
) -> torch.Tensor:
    """Attention with online softmax; the output has q's dtype.

    ``backend`` is checked as :func:`repro_torch.kernels.backend.resolve_backend`
    checks it (``"cuda"``, ``"torch"`` or ``"auto"``; ``"torch"`` is refused
    on the card). The computation is :func:`flash_attention`'s, which
    launches the kernel for CUDA tensors and takes the plain version for
    CPU tensors, so both backends give the plain version on the CPU.

    Differentiable: when grad is enabled and q, k or v requires it, the
    call goes through :class:`_Attention`, the reference's custom VJP.
    """
    resolve_backend(backend, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, q_offset)
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


class _Attention(torch.autograd.Function):
    """The reference's ``attention`` VJP: the forward is
    :func:`flash_attention` (K5 for CUDA tensors) and saves q, k and v;
    the backward recomputes the plain version under autograd and returns
    its dq, dk and dv (``_attention_bwd``). The reference has no backward
    Pallas kernel ("a TPU-side optimization; semantics identical"), so the
    plain recompute holds [BH, Sq, Skv] float32 scores while it runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = ref.flash_attention_ref(qd, kd, vd, causal=causal, window=window,
                                          q_offset=q_offset).to(q.dtype)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None
