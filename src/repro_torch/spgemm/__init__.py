"""Plan/execute SpGEMM on PyTorch: the paper's two-phase product C = A·B.

``spgemm_plan(a, b)`` runs the symbolic phase once (sparse-native
conversion to BCSV/BCSR, the block-Gustavson triple schedule and the
output assembly map) and returns an :class:`SpGEMMPlan`;
``plan.execute(a_vals, b_vals)`` and ``plan.execute_batch(...)`` run the
numeric phase on the device through the hand-written CUDA kernel
(``device="cuda"``, the default) or its plain PyTorch version
(``device="cpu"``)::

    plan = spgemm_plan(a, b, tile=64, group=4)
    c = plan.execute(a_vals, b_vals)          # CSR, structural pattern
    cs = plan.execute_batch(a_batch, b_batch)  # list of CSR

The module layout and public names follow the JAX package ``repro.spgemm``;
its plan cache, pipeline, sharding, autotuner and gateway are not ported
yet.
"""
from repro_torch.spgemm.cache import pattern_digest
from repro_torch.spgemm.executor import (
    CHUNK_BYTES_ENV,
    SpGEMMExecutor,
    resolve_chunk_bytes,
)
from repro_torch.spgemm.plan import (
    PlanReport,
    SpGEMMPlan,
    resolve_backend,
    resolve_device,
    spgemm_plan,
)

__all__ = [
    "CHUNK_BYTES_ENV",
    "PlanReport",
    "SpGEMMExecutor",
    "SpGEMMPlan",
    "pattern_digest",
    "resolve_backend",
    "resolve_chunk_bytes",
    "resolve_device",
    "spgemm_plan",
]
