"""Public entry points over the kernels.

Ported: the sparse x sparse shim (``spgemm``) and prefill ``attention``
(the flash kernel). The dense-activation and grouped-matmul entry points
wait for their kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.schedule import SpGEMMSchedule
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sparse.formats import BCSR, BCSV, CSR
from repro_torch.spgemm.plan import SpGEMMPlan, spgemm_plan

__all__ = ["attention", "spgemm"]


def spgemm(
    a: BCSV,
    b: BCSR,
    *,
    backend: str = "auto",
    device="cuda",
    schedule: Optional[SpGEMMSchedule] = None,
) -> CSR:
    """C = A @ B for block-sparse A (BCSV) and B (BCSR).

    Thin shim over :mod:`repro_torch.spgemm`: builds a plan for this
    sparsity pattern (reusing ``schedule`` when the caller already ran the
    symbolic phase) and runs its numeric phase once. Callers that reuse
    one pattern should hold a plan (``spgemm_plan``) instead.

    The returned CSR has C's *structural* pattern (every element of every
    structurally nonzero C block): elements that compute to exact zero are
    stored explicitly.
    """
    if schedule is not None:
        plan = SpGEMMPlan.from_blocks(
            a, b, backend=backend, device=device, schedule=schedule
        )
    else:
        plan = spgemm_plan(a, b, backend=backend, device=device)
    return plan.execute()


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

    Forward only: the reference's recompute backward (a custom VJP through
    the plain version) comes with the training slice, so CUDA inputs that
    require grad raise.
    """
    resolve_backend(backend, q.device)
    if q.device.type == "cuda" and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        raise NotImplementedError(
            "attention has no backward on the card yet: the recompute VJP "
            "comes with the training slice (ROADMAP queue 1, item 15)"
        )
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
