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

Beside them: element-exact output (``output="compact"``), element-granular
plans (``output="exact"``, tile 1, group 1), device-resident chains
(``plan.then``, :func:`chain_plans`, :func:`execute_chain`,
:func:`plan_from_structural_pattern`; held against the plain float64 chain
of :mod:`repro_torch.spgemm.plain`), and the asynchronous submit/collect
pipeline (``plan.pipeline``, ``execute_async``, ``execute_stream``;
:class:`SpGEMMPipeline`), whose in-flight steps run on CUDA streams of
their own on the card::

    with plan.pipeline(depth=2) as pipe:      # the paper's double buffer
        for c in pipe.stream(value_iter):
            consume(c)

Plans are cached (:class:`PlanCache`: a memory LRU, and a disk tier,
:class:`PlanStore`, from which a restarted worker rehydrates its plans
without re-running the symbolic phase; ``REPRO_TORCH_SPGEMM_PLAN_DIR``
enables it on the process-level :func:`default_cache`), and
``spgemm_plan(..., mesh=make_shard_mesh(n, devices=...))`` partitions the
schedule over the devices of a mesh (:class:`ShardedSpGEMMPlan`), bitwise
equal to the single-device plan.

Per pattern, ``spgemm_plan(..., autotune=True)`` searches (tile, group) ×
chunk budget × pipeline depth — a roofline model over the schedule's
counts prunes the grid, short probes through the kernels measure the
rest — and applies and persists the winner (:class:`TunedConfig`, a
sidecar of the disk tier: a restarted worker starts tuned with zero
probes). :class:`SpGEMMGateway` serves many tenants' patterns at once:
typed sheds (:class:`Outcome`), micro-batches through each pattern's
pipeline, deficit round-robin by value bytes, a bounded pipeline pool,
and p50/p99 metrics in a ``runtime.heartbeat.MetricsRegistry``::

    with SpGEMMGateway(max_batch=8, depth=2) as gw:
        gw.register("tenant/layer", a, b, tile=64, group=4)
        c = gw.submit("tenant/layer", a_vals, b_vals).result()

``spgemm_plan(..., validate="deep")`` verifies whatever the call returns
(fresh build, memory hit, disk rehydrate) with
:func:`repro_torch.analysis.verify_plan`, without running the numeric
phase; rehydrates are verified inside the loader, so a digest-valid but
corrupted artifact falls back to a clean symbolic rebuild before it can
reach the kernel.

The module layout and public names follow the JAX package ``repro.spgemm``.
"""
from repro_torch.spgemm.autotune import TunedConfig, autotune_plan, probe_run_count
from repro_torch.spgemm.cache import CacheStats, PlanCache, default_cache, pattern_digest
from repro_torch.spgemm.executor import (
    CHUNK_BYTES_ENV,
    ShardedSpGEMMExecutor,
    SpGEMMExecutor,
    resolve_chunk_bytes,
)
from repro_torch.spgemm.gateway import (
    GatewayResult,
    GatewayShed,
    GatewayTicket,
    Outcome,
    SpGEMMGateway,
)
from repro_torch.spgemm.persist import PLAN_DIR_ENV, PlanStore
from repro_torch.spgemm.pipeline import (
    PipelineFullError,
    SpGEMMPipeline,
    SpGEMMTicket,
)
from repro_torch.spgemm.plan import (
    PlanReport,
    ShardedSpGEMMPlan,
    SpGEMMChain,
    SpGEMMPlan,
    StructuralPattern,
    chain_plans,
    execute_chain,
    plan_from_structural_pattern,
    resolve_backend,
    resolve_device,
    schedule_build_count,
    spgemm_plan,
)

__all__ = [
    "CHUNK_BYTES_ENV",
    "CacheStats",
    "GatewayResult",
    "GatewayShed",
    "GatewayTicket",
    "Outcome",
    "PLAN_DIR_ENV",
    "PipelineFullError",
    "PlanCache",
    "PlanReport",
    "PlanStore",
    "ShardedSpGEMMExecutor",
    "ShardedSpGEMMPlan",
    "SpGEMMChain",
    "SpGEMMExecutor",
    "SpGEMMGateway",
    "SpGEMMPipeline",
    "SpGEMMPlan",
    "SpGEMMTicket",
    "StructuralPattern",
    "TunedConfig",
    "autotune_plan",
    "chain_plans",
    "default_cache",
    "execute_chain",
    "pattern_digest",
    "plan_from_structural_pattern",
    "probe_run_count",
    "resolve_backend",
    "resolve_chunk_bytes",
    "resolve_device",
    "schedule_build_count",
    "spgemm_plan",
]
