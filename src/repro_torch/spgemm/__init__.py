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

Beside them: element-exact output (``output="compact"``), device-resident
chains (``plan.then``, :func:`chain_plans`, :func:`execute_chain`,
:func:`plan_from_structural_pattern`), and the asynchronous submit/collect
pipeline (``plan.pipeline``, ``execute_async``, ``execute_stream``;
:class:`SpGEMMPipeline`), whose in-flight steps run on CUDA streams of
their own on the card::

    with plan.pipeline(depth=2) as pipe:      # the paper's double buffer
        for c in pipe.stream(value_iter):
            consume(c)

The module layout and public names follow the JAX package ``repro.spgemm``;
its plan cache, sharding, autotuner and gateway are not ported yet.
"""
from repro_torch.spgemm.cache import pattern_digest
from repro_torch.spgemm.executor import (
    CHUNK_BYTES_ENV,
    SpGEMMExecutor,
    resolve_chunk_bytes,
)
from repro_torch.spgemm.pipeline import (
    PipelineFullError,
    SpGEMMPipeline,
    SpGEMMTicket,
)
from repro_torch.spgemm.plan import (
    PlanReport,
    SpGEMMChain,
    SpGEMMPlan,
    StructuralPattern,
    chain_plans,
    execute_chain,
    plan_from_structural_pattern,
    resolve_backend,
    resolve_device,
    spgemm_plan,
)

__all__ = [
    "CHUNK_BYTES_ENV",
    "PipelineFullError",
    "PlanReport",
    "SpGEMMChain",
    "SpGEMMExecutor",
    "SpGEMMPipeline",
    "SpGEMMPlan",
    "SpGEMMTicket",
    "StructuralPattern",
    "chain_plans",
    "execute_chain",
    "pattern_digest",
    "plan_from_structural_pattern",
    "resolve_backend",
    "resolve_chunk_bytes",
    "resolve_device",
    "spgemm_plan",
]
