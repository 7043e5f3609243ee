"""Public entry points over the kernels.

Only the sparse x sparse shim is ported; the dense-activation, grouped
matmul and attention entry points wait for their kernels.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.schedule import SpGEMMSchedule
from repro_torch.sparse.formats import BCSR, BCSV, CSR
from repro_torch.spgemm.plan import SpGEMMPlan, spgemm_plan

__all__ = ["spgemm"]


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
