"""Plan/execute SpGEMM: symbolic phase once, device-resident numeric phase.

FSpGEMM's host-side claim (Sec. 4.3) is that CSV pre-processing "only needs
to be performed once". This module is that claim as an API:

* :func:`spgemm_plan` runs every amortizable step once — sparse-native
  format conversion (COO -> BCSV/BCSR with value-scatter indices), the
  symbolic block-Gustavson phase (C structure + static triple schedule +
  the :class:`~repro_torch.core.schedule.AssemblyMap` output-scatter
  structure) and device staging — and returns a :class:`SpGEMMPlan`.
* The numeric phase is :class:`~repro_torch.spgemm.executor.SpGEMMExecutor`:
  value rebind, the scheduled kernel and output assembly on the device;
  C's CSR pattern is precomputed, so assembly is a single static gather.
* :meth:`SpGEMMPlan.execute` binds fresh values (no-arg ``execute()``
  reuses the bound ones), stages on the device what is not there yet and
  wraps the packed C values in the precomputed CSR structure;
  :meth:`SpGEMMPlan.execute_batch` runs a leading batch of value sets.
* :meth:`SpGEMMPlan.pipeline` / ``execute_async`` / ``execute_stream``
  serve a stream of value sets through a bounded submit/collect pipeline
  (:mod:`repro_torch.spgemm.pipeline`): on the card each in-flight step
  runs on a CUDA stream of its own, so copies overlap kernels.
* ``output="compact"`` stores only C's element-exact structural nonzeros
  (no block fill); plans compose into chains (:meth:`SpGEMMPlan.then`,
  :func:`plan_from_structural_pattern`, :func:`execute_chain`) whose
  intermediates never leave the device.
* ``output="exact"`` (tile 1, group 1) computes C at element granularity,
  the paper's row-wise Gustavson with no blocks at all: the symbolic phase
  is a vectorized pair expansion
  (:func:`~repro_torch.core.schedule.build_exact_schedule`), whose panels
  are C's entries in CSR order, and the kernel runs its 1 x 1 x 1
  specialization, one thread per entry. Block fill costs nothing here,
  which is what an unstructured pattern needs: at any tile K1 takes, its
  blocks would hold almost nothing but fill. Exact plans serve
  ``execute``, ``execute_batch``, the pipeline and chains of exact plans
  (an algebraic multigrid's Galerkin product ``R·A·P``); they are not
  sharded, persisted or autotuned yet (those raise ``ValueError``).
* Plans are cached (:mod:`repro_torch.spgemm.cache`) keyed on
  ``(pattern hash, tile, group, backend, device, mesh key)``: a memory LRU
  and, opt-in, a disk tier from which a restarted worker rehydrates its
  plans without re-running the symbolic phase; ``pattern_token`` is the
  serving warm path's fast key.
* ``mesh=`` (:func:`repro_torch.launch.mesh.make_shard_mesh`) gives a
  :class:`ShardedSpGEMMPlan`: the schedule partitioned at block-row-group
  boundaries, one program per shard on its device, bitwise equal to the
  single-device plan.

Plans run on the card: ``device="cuda"`` is the default and raises when no
CUDA device is present; ``device="cpu"`` runs the plain PyTorch version.

Value dtype: a plan keeps the packed dtype of the values it was built on,
as the JAX package does: bfloat16 (a numpy array whose dtype is named
``bfloat16``, or a bfloat16 tensor) or float32 (every other float type;
float64 is cast, as the JAX package does with 64-bit mode off). Every
later rebind, single or batched, host or device, rounds its values to that
dtype (round to nearest even, as ``astype`` does), and a bfloat16 plan
stages bfloat16 values, so the kernel reads bfloat16 blocks; C is float32
either way. The port imports no ``ml_dtypes``: a numpy bfloat16 array is
read through a 16-bit view, and the plan holds its values on the host as
CPU tensors of its dtype.

Output convention: C's CSR pattern is *structural* (every element of every
structurally nonzero C block, trimmed to the true shape, or under
``output="compact"`` and ``output="exact"`` every element some product
reaches), so values that
compute to exact zero are stored explicitly — the pattern is
value-independent, which is what makes assembly a static gather.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.schedule import (
    AssemblyMap,
    ScheduleShard,
    SpGEMMSchedule,
    _blocks_ascending,
    assembly_from_arrays,
    assembly_map_on,
    assembly_to_arrays,
    build_assembly_map,
    build_compact_map,
    build_exact_schedule,
    build_spgemm_schedule,
    exact_assembly_map,
    partition_spgemm_schedule,
    schedule_from_arrays,
    schedule_to_arrays,
    shards_from_bounds,
    shards_to_bounds,
    structural_product_pattern,
)
from repro_torch.kernels.backend import resolve_backend, resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime.heartbeat import default_registry, span, traced
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo, to_coo
from repro_torch.sparse.formats import BCSR, BCSV, COO, CSR
from repro_torch.spgemm.cache import PlanCache, default_cache, pattern_digest
from repro_torch.spgemm.executor import (
    CHUNK_BYTES_ENV,
    ShardedSpGEMMExecutor,
    SpGEMMExecutor,
    _collect,
    _copy_out,
    _download,
    _pinned_copy,
)
from repro_torch.spgemm.pipeline import SpGEMMPipeline, SpGEMMTicket, _Prepared

__all__ = [
    "PlanReport",
    "ShardedSpGEMMPlan",
    "SpGEMMChain",
    "SpGEMMPlan",
    "StructuralPattern",
    "chain_plans",
    "execute_chain",
    "plan_from_structural_pattern",
    "resolve_backend",
    "resolve_device",
    "schedule_build_count",
    "spgemm_plan",
]

# Global count of symbolic-phase runs (schedule constructions). Tests and
# the card's checks assert that it stays flat across cached and
# rehydrated plans.
_SCHEDULE_BUILDS = 0


def schedule_build_count() -> int:
    return _SCHEDULE_BUILDS


def _build_schedule(a: BCSV, b: BCSR) -> SpGEMMSchedule:
    """The symbolic phase, counted."""
    global _SCHEDULE_BUILDS
    with span("spgemm.plan.schedule"):
        schedule = build_spgemm_schedule(a, b)
    _SCHEDULE_BUILDS += 1
    return schedule


def _build_exact_schedule(a: COO, b: COO) -> SpGEMMSchedule:
    """The element symbolic phase of an ``output="exact"`` plan, counted
    as :func:`_build_schedule` counts the block one."""
    global _SCHEDULE_BUILDS
    with span("spgemm.plan.schedule"):
        schedule = build_exact_schedule(a.row, a.col, b.row, b.col, a.shape, b.shape)
    _SCHEDULE_BUILDS += 1
    return schedule


def _not_served(what: str) -> ValueError:
    """The error of an entry that ``output="exact"`` plans do not serve."""
    return ValueError(f"output='exact' plans do not serve {what} yet: use output='block' "
                      f"or 'compact' for it")


def _check_exact(tile, group, mesh, mesh_axis) -> None:
    """What an ``output="exact"`` plan takes: tile 1, group 1, one device."""
    if _normalize_tile(tile) != (1, 1, 1) or int(group) != 1:
        raise ValueError(f"output='exact' takes tile=1, group=1; got tile={tile!r}, "
                         f"group={group!r}")
    if mesh is not None or mesh_axis is not None:
        raise _not_served("sharded plans (mesh=)")


def _mixed_chain() -> ValueError:
    """The error of a chain that mixes ``output="exact"`` stages with others."""
    return ValueError("a chain is either all output='exact' plans or has no exact stage: "
                      "build every stage with the same output")


_REPORT_FIELDS = (
    "pattern_key", "pattern_token", "tile", "group", "backend", "shape",
    "nnz_a", "nnz_b", "nnzb_a", "nnzb_b", "nnzb_c", "num_triples",
    "n_panels", "b_fetches", "block_omar", "schedule_builds", "cache_hits",
    "executes", "loads", "load_hits", "cache_stats", "config_source",
    "tuned",
)


class PlanReport:
    """Structured statistics of one plan: what was built, what it costs,
    and how often it has been reused.

    ``pattern_key``, ``nnz_a``, and ``nnz_b`` may be supplied as zero-arg
    callables: they resolve (and memoize) on first access, so plan paths
    whose report nobody reads never pay the pattern digest or the
    ``count_nonzero`` scans. ``cache_hits``, ``loads``, ``load_hits``,
    ``cache_stats`` and ``pattern_token`` are set by the plan cache;
    ``config_source`` and ``tuned`` by :meth:`SpGEMMPlan.apply_tuned_config`
    (the autotuner's provenance record).
    """

    def __init__(
        self,
        pattern_key: Union[str, Callable[[], str]],
        tile: Tuple[int, int, int],
        group: int,
        backend: str,
        shape: Tuple[int, int],  # output C shape
        nnz_a: Union[int, Callable[[], int]],
        nnz_b: Union[int, Callable[[], int]],
        nnzb_a: int,
        nnzb_b: int,
        nnzb_c: int,
        num_triples: int,
        n_panels: int,
        b_fetches: int,
        block_omar: float,
        schedule_builds: int = 1,  # symbolic-phase runs for this plan (0
        # when a pre-built schedule or persisted artifacts were supplied)
        cache_hits: int = 0,
        executes: int = 0,  # numeric-phase runs (value sets, for batches)
        loads: int = 0,  # 1 when built from persisted artifacts
        load_hits: int = 0,
        cache_stats: Optional[dict] = None,
        pattern_token: Optional[str] = None,
        config_source: str = "default",  # "default" (policy), "tuned"
        # (autotuned here), "persisted" (a tuned config loaded from disk),
        # "stale-tuned" (a config of another tile/group, ignored) or
        # "env-override" (REPRO_SPGEMM_CHUNK_BYTES wins regardless)
        tuned: Optional[dict] = None,  # the applied TunedConfig's meta
    ):
        self._pattern_key = pattern_key
        self._nnz_a = nnz_a
        self._nnz_b = nnz_b
        self.tile = tuple(tile)
        self.group = group
        self.backend = backend
        self.shape = tuple(shape)
        self.nnzb_a = nnzb_a
        self.nnzb_b = nnzb_b
        self.nnzb_c = nnzb_c
        self.num_triples = num_triples
        self.n_panels = n_panels
        self.b_fetches = b_fetches
        self.block_omar = block_omar
        self.schedule_builds = schedule_builds
        self.cache_hits = cache_hits
        self.executes = executes
        self.loads = loads
        self.load_hits = load_hits
        self.cache_stats = cache_stats
        self.pattern_token = pattern_token
        self.config_source = config_source
        self.tuned = tuned
        # The VerifyReport of the last validate="deep" check that accepted
        # this plan (None if it was never deep-validated). It is true as of
        # that check only: apply_tuned_config clears it, and a caller that
        # needs a current report runs verify_plan.
        self.verify_report = None

    @property
    def pattern_key(self) -> str:
        if callable(self._pattern_key):
            self._pattern_key = self._pattern_key()
        return self._pattern_key

    @property
    def nnz_a(self) -> int:
        if callable(self._nnz_a):
            self._nnz_a = self._nnz_a()
        return self._nnz_a

    @property
    def nnz_b(self) -> int:
        if callable(self._nnz_b):
            self._nnz_b = self._nnz_b()
        return self._nnz_b

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in _REPORT_FIELDS}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"PlanReport(shape={self.shape}, triples={self.num_triples},"
                f" executes={self.executes})")


def _packed_dtype(vals) -> torch.dtype:
    """The packed dtype a plan built on ``vals`` holds: bfloat16 for
    bfloat16 values (a tensor, or a numpy array whose dtype is named
    ``bfloat16``), float32 for any other."""
    if isinstance(vals, torch.Tensor):
        return torch.bfloat16 if vals.dtype == torch.bfloat16 else torch.float32
    return torch.bfloat16 if np.asarray(vals).dtype.name == "bfloat16" else torch.float32


def _as_tensor(vals, dtype: torch.dtype) -> torch.Tensor:
    """Values from a numpy array (bfloat16 included) or a tensor, as a
    tensor of ``dtype`` on the tensor's device (numpy: on the host),
    rounded to nearest even. Float64 passes through float32 first, as
    ``astype`` to bfloat16 does."""
    if isinstance(vals, torch.Tensor):
        vals = vals.detach()
        if vals.dtype == torch.float64:
            vals = vals.float()
        return vals.to(dtype)
    vals = np.asarray(vals)
    if vals.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(vals).view(np.uint16)).view(
            torch.bfloat16).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(dtype)


def _host_values(vals, dtype: torch.dtype) -> torch.Tensor:
    """Values as a contiguous CPU tensor of ``dtype``."""
    return _as_tensor(vals, dtype).cpu().contiguous()


def _device_values(vals, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Values as a contiguous tensor of ``dtype`` on ``device`` (a tensor
    already there is not copied through the host)."""
    return _as_tensor(vals, dtype).to(device).contiguous()


def _copy_span(name: str, counter: str, nbytes: int):
    """``span(name, bytes=nbytes)`` around a copy of ``nbytes`` between
    host and device, which the process-level counter ``counter`` also
    counts (traced or not)."""
    default_registry().counter(counter).inc(nbytes)
    return span(name, bytes=nbytes)


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's name of a packed value dtype."""
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def _value_dtype(dtype) -> torch.dtype:
    """A requested value dtype (torch or numpy, by name) as the packed
    dtype a plan holds: bfloat16, or float32 for any other."""
    return torch.bfloat16 if "bfloat16" in str(dtype) else torch.float32


def _assembly_on_card(device, schedule, block_shape, out_shape):
    """The block assembly map built on the CUDA ``device``
    (:func:`~repro_torch.core.schedule.assembly_map_on`): the host map,
    copied back once into page-locked memory, and its gather, left on the
    device."""
    on = assembly_map_on(device, schedule, block_shape, out_shape)
    pending = [_copy_out(t) for t in (on.gather, on.indptr, on.indices)]
    gather, indptr, indices = (_collect(p).numpy() for p in pending)
    return AssemblyMap(gather, indptr, indices, on.shape), on.gather


class SpGEMMPlan:
    """A fully pre-processed SpGEMM: symbolic phase done, numeric phase
    repeatable — single-shot, batched or pipelined — with fresh values.

    Build through :func:`spgemm_plan` or :meth:`SpGEMMPlan.from_blocks`.
    ``execute`` / ``__call__`` accept new value sets bound to the *same*
    sparsity pattern:

    * element plans (built from COO/CSR/dense inputs): ``a_vals`` is a
      ``[nnz_a]`` vector aligned with ``plan.a_pattern`` (canonical
      row-major deduplicated order), likewise ``b_vals``;
    * block plans (built from BCSV/BCSR inputs): ``a_vals`` is a packed
      ``[nnzb_a, bm, bk]`` block array, likewise ``b_vals``.

    Values may be numpy arrays or tensors. Passing ``None`` reuses the
    values bound at build, by the last execute or by a cache hit.
    ``execute_batch`` takes the same per-set shapes with a leading batch
    axis.

    The plan holds one value state per operand, in its value shape
    (:meth:`value_shapes`): a host copy of its own (page-locked on the
    card) and a device copy in the executor's layout, staged when a run
    first needs it. Values handed over as a tensor on a CUDA plan's
    device stay there: the device copy is the plan's clone of them, and
    a host copy is made, by one copy back, only for a reader that drops
    the device copies (:meth:`release_device_values`). :meth:`_bind` is
    the one writer of the values; the executor alone decides whether
    values become packed blocks on the device.

    ``output="compact"`` wraps results in the element-exact map
    (``plan.compact``) instead of the block-structural one
    (``plan.assembly``); block plans have no element pattern, so there the
    compact map is the block map itself. ``output="exact"`` plans are
    built at tile 1 and group 1, where the block map is element-exact: its
    gather is the identity, as are both operands' scatters.

    Results returned by one plan share the precomputed CSR ``indptr`` /
    ``indices`` arrays (treat them as read-only).
    """

    def __init__(
        self,
        *,
        schedule: SpGEMMSchedule,
        a_vals,
        b_vals,
        block_shapes: Tuple[Tuple[int, ...], Tuple[int, ...]],
        value_dtypes: Tuple[torch.dtype, torch.dtype],
        backend: str,
        device,
        out_shape: Tuple[int, int],
        report: PlanReport,
        a_scatter: Optional[np.ndarray] = None,
        b_scatter: Optional[np.ndarray] = None,
        a_pattern: Optional[COO] = None,
        b_pattern: Optional[COO] = None,
        assembly: Optional[AssemblyMap] = None,
        output: str = "block",
        compact: Optional[AssemblyMap] = None,
    ):
        _check_output(output)
        self.schedule = schedule
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.report = report
        self.a_pattern = a_pattern
        self.b_pattern = b_pattern
        self._a_scatter = a_scatter
        self._b_scatter = b_scatter
        # The packed dtypes of the values the plan was built on, the packed
        # block shapes, and the bound values in the plan's value shape (CPU
        # tensors of those dtypes; None once release_values() dropped
        # them, or while values bound from the card are held there only).
        # One array passed as both operands is held, and staged, once.
        self._a_dtype, self._b_dtype = value_dtypes
        self._a_shape, self._b_shape = (tuple(int(x) for x in sh) for sh in block_shapes)
        self._a_host = _host_values(a_vals, self._a_dtype)
        self._b_host = self._a_host if b_vals is a_vals and self._b_dtype == self._a_dtype \
            else _host_values(b_vals, self._b_dtype)
        self._m, self._n = out_shape
        self._group = schedule.group
        self._bm = int(self._a_shape[1]) if len(self._a_shape) == 3 else 0
        self._bn = int(self._b_shape[2]) if len(self._b_shape) == 3 else 0
        self.output = output
        self.compact: Optional[AssemblyMap] = compact
        with span("spgemm.plan.assembly") as assembly_span:
            # Symbolic output structure: C's CSR pattern + the panels->CSR
            # gather map, consumed on device by the executor. A CUDA plan
            # builds the block map on the card (the same map, bitwise) and
            # keeps that gather there for its executor.
            if assembly is None and output == "exact":
                assembly = exact_assembly_map(schedule, out_shape)
            block_gather = None
            if (assembly is None and self.device.type == "cuda" and self._assembles_on_device
                    and _blocks_ascending(schedule.c_brow, schedule.c_bcol, schedule.grid_n)):
                assembly, block_gather = _assembly_on_card(
                    self.device, schedule, (self._bm, self._bn), out_shape)
            self.assembly: AssemblyMap = (
                assembly if assembly is not None
                else build_assembly_map(schedule, (self._bm, self._bn), out_shape)
            )
            assembly_span.count(on_device=int(block_gather is not None))
            # Output mode and the element-exact compact map: a subset of
            # the block map's positions, so gathering through it is the
            # compaction (no nonzero scan).
            if output == "compact" and self.compact is None:
                if a_pattern is not None and b_pattern is not None:
                    rows, cols = structural_product_pattern(
                        a_pattern.row, a_pattern.col, b_pattern.row, b_pattern.col,
                        a_pattern.shape, b_pattern.shape,
                    )
                    self.compact = build_compact_map(self.assembly, rows, cols)
                else:
                    self.compact = self.assembly
        # ``_make_executor`` is the subclass seam: ShardedSpGEMMPlan
        # replaces it with the sharded executor.
        with span("spgemm.plan.stage"):
            self._executor = (
                self._make_executor(block_gather if output != "compact" else None)
                if schedule.num_triples and self.assembly.nnz
                else None
            )
        # The bound values on the device, in the executor's layout: staged
        # by the first run that needs them, dropped by every rebind from
        # the host, and the only copy of values bound from the card.
        self._a_dev = None
        self._b_dev = None
        # Device copy of B's element values, staged by the first chained
        # execute (a later chain stage multiplies the previous stage's
        # device values by b_pattern's, as in the JAX package).
        self._b_vals_dev = None
        # Guards value rebinds + report counters, so concurrent executes
        # each see a consistent (values, device array) pair.
        self._lock = threading.Lock()
        # Pipeline steps submitted and not yet collected (or discarded):
        # while nonzero, buffer teardown refuses.
        self._inflight = 0
        self._released = False
        # The side streams pipelines over this plan run their steps on
        # (CUDA plans; made on demand). Kept by the plan so that every
        # pipeline reuses them, and with them the device memory PyTorch's
        # caching allocator keeps per stream.
        self._streams: list = []
        # (weakref to the cache, key), set by PlanCache on insert;
        # release() evicts through it so a dead plan never stays resident.
        self._cache_ref = None
        # The value dtype names of the inputs the plan was built or found
        # for (spgemm_plan sets them): a pattern-token hit must not serve
        # inputs of another value dtype.
        self._input_dtypes: Optional[Tuple[str, str]] = None
        # The autotuner's applied TunedConfig (apply_tuned_config), and a
        # config that was offered for another (tile, group) than this
        # plan's: recorded instead of raised, the plan runs on policy
        # defaults and the static verifier reports it.
        self.tuned_config = None
        self._stale_tuned = None

    # A CUDA plan builds its block assembly map on the card; a sharded
    # plan slices the host map per shard, so it builds the map on the host.
    _assembles_on_device = True
    # A CUDA plan's executor reads values on the card in their value
    # shape, so values bound there are its device copy; a sharded plan
    # lays them out per shard, and binds every value through the host.
    _binds_on_device = True

    def _make_executor(self, gather=None):
        """The numeric executor (called once, at plan build). ``gather`` is
        the active map's gather where it is already on the device."""
        return SpGEMMExecutor(
            schedule=self.schedule,
            assembly=self._active(),
            backend=self.backend,
            device=self.device,
            a_scatter=self._a_scatter,
            b_scatter=self._b_scatter,
            a_shape=self._a_shape,
            b_shape=self._b_shape,
            gather=gather,
        )

    @property
    def kind(self) -> str:
        """``"element"`` for a plan built from element inputs (its values
        are ``[nnz]`` vectors in canonical pattern order, bound into packed
        blocks on the device), ``"block"`` for one built from packed blocks
        (BCSV/BCSR), whose values are the blocks."""
        return "element" if self._a_scatter is not None and self._b_scatter is not None \
            else "block"

    def _active(self) -> AssemblyMap:
        """The output map results are wrapped in (and the executor gathers
        through): the compact map under ``output="compact"``, else the
        block-structural map."""
        return self.compact if self.output == "compact" else self.assembly

    def apply_tuned_config(self, cfg) -> None:
        """Apply an autotuner :class:`~repro_torch.spgemm.autotune.TunedConfig`:
        set the executor's chunk budget and make ``cfg.pipeline_depth``
        the default for :meth:`pipeline` / :meth:`execute_stream`.

        Numerics are untouched — chunk and depth are bitwise-invariant
        knobs, and a config tuned at another (tile, group) is applied to
        the plan *built at that tile/group* by the autotuner, never here.
        Report provenance: ``config_source`` becomes ``"tuned"``, or
        ``"persisted"`` for a config loaded from disk, unless
        ``REPRO_SPGEMM_CHUNK_BYTES`` is set, which always wins and keeps
        ``"env-override"``.

        A config whose (tile, group) does not match this plan is *stale*
        (a persisted record that drifted from the artifact it rode with).
        It is not an execution error — the plan is correct on policy
        defaults — so it is recorded instead of raised: the config is
        ignored, ``report.config_source`` becomes ``"stale-tuned"`` and
        ``_stale_tuned`` keeps it for the static verifier.
        """
        if tuple(cfg.tile) != tuple(self.report.tile) or (
            int(cfg.group) != int(self.report.group)
        ):
            with self._lock:
                self._stale_tuned = cfg
                self.tuned_config = None
                self.report.tuned = None
                self.report.verify_report = None
                if not os.environ.get(CHUNK_BYTES_ENV):
                    self.report.config_source = "stale-tuned"
            return
        with self._lock:
            self.tuned_config = cfg
            self.report.tuned = cfg.to_meta()
            self.report.verify_report = None
            if os.environ.get(CHUNK_BYTES_ENV):
                self.report.config_source = "env-override"
            else:
                self.report.config_source = (
                    "persisted" if cfg.source == "persisted" else "tuned"
                )
            if self._executor is not None:
                self._executor.set_chunk_bytes(cfg.chunk_bytes)

    def _default_depth(self) -> int:
        """The pipeline depth when none is asked for: the tuned depth of
        an applied :class:`TunedConfig`, else 2, the paper's double
        buffer."""
        cfg = self.tuned_config
        return int(cfg.pipeline_depth) if cfg is not None else 2

    # -- construction -----------------------------------------------------

    @classmethod
    def from_blocks(
        cls,
        a: BCSV,
        b: BCSR,
        *,
        backend: str = "auto",
        device="cuda",
        schedule: Optional[SpGEMMSchedule] = None,
        pattern_key: str = "",
        mesh: Optional[Mesh] = None,
        mesh_axis: Optional[str] = None,
        output: str = "block",
    ) -> "SpGEMMPlan":
        """Plan from pre-converted block formats (the ops.spgemm shim path).

        When ``schedule`` is supplied the symbolic phase is skipped
        (``report.schedule_builds == 0``). The pattern digest and element
        nnz counts in the report are computed only if read. ``mesh``
        gives a :class:`ShardedSpGEMMPlan`.
        """
        if output == "exact":
            raise _not_served("pre-converted block inputs (pass element inputs)")
        device = resolve_device(device)
        backend = resolve_backend(backend, device)
        built = 0
        if schedule is None:
            schedule = _build_schedule(a, b)
            built = 1
        if not pattern_key:
            idx = (a.brow, a.bcol, a.group_ptr, b.indptr, b.indices)
            meta = ("blocks", a.shape, b.shape, a.block_shape,
                    b.block_shape, a.group, str(a.blocks.dtype),
                    str(b.blocks.dtype))

            def pattern_key(idx=idx, meta=meta):
                return pattern_digest(*idx, meta=meta)
        report = _make_report(
            pattern_key,
            (a.block_shape[0], a.block_shape[1], b.block_shape[1]),
            a.group, backend, (a.shape[0], b.shape[1]),
            0, 0,  # placeholders; bound to staged blocks below
            a.nnzb, b.nnzb, schedule,
        )
        report.schedule_builds = built
        plan_cls, extra = _resolve_plan_cls(mesh, mesh_axis)
        plan = plan_cls(
            schedule=schedule,
            a_vals=a.blocks,
            b_vals=b.blocks,
            block_shapes=(a.blocks.shape, b.blocks.shape),
            value_dtypes=(_packed_dtype(a.blocks), _packed_dtype(b.blocks)),
            backend=backend,
            device=device,
            out_shape=(a.shape[0], b.shape[1]),
            report=report,
            output=output,
            **extra,
        )
        report._nnz_a = _staged_nnz(plan, "a", "nnz_a")
        report._nnz_b = _staged_nnz(plan, "b", "nnz_b")
        return plan

    # -- persistence -------------------------------------------------------

    def persist_artifacts(self) -> Tuple[dict, dict]:
        """The plan's value-independent symbolic artifacts as ``(arrays,
        meta)``, in the JAX package's layout: the triple schedule, the
        assembly map, the compact map under the ``casm.`` prefix (compact
        plans) and the value-scatter indices (element plans;
        :class:`ShardedSpGEMMPlan` adds its shard bounds); ``meta`` holds
        the geometry (packed block shapes and dtypes, output shape, tile,
        group, backend). Values are excluded: a warm restart brings its
        own (:meth:`from_artifacts`). This is the payload the disk tier
        (:class:`repro_torch.spgemm.persist.PlanStore`) writes once per
        cache key. ``output="exact"`` plans are not persisted yet
        (``ValueError``)."""
        if self.output == "exact":
            raise _not_served("persistence")
        arrays = {}
        arrays.update(schedule_to_arrays(self.schedule))
        arrays.update(assembly_to_arrays(self.assembly))
        if self.output == "compact":
            arrays.update(assembly_to_arrays(self.compact, prefix="casm."))
        if self.kind == "element":
            arrays["a_scatter"] = self._a_scatter
            arrays["b_scatter"] = self._b_scatter
        meta = {
            "kind": self.kind,
            "output": self.output,
            "backend": self.backend,
            "out_shape": [self._m, self._n],
            "a_shape": list(self._a_shape),
            "b_shape": list(self._b_shape),
            "a_dtype": _dtype_name(self._a_dtype),
            "b_dtype": _dtype_name(self._b_dtype),
            "tile": list(self.report.tile),
            "group": self.report.group,
        }
        if self.tuned_config is not None:
            # The tuned exec config rides inside the plan artifact too (in
            # addition to the cache's sidecar record), so a copied or
            # shared artifact file rehydrates fully tuned on its own.
            meta["tuned_config"] = self.tuned_config.to_meta()
        return arrays, meta

    @classmethod
    def from_artifacts(
        cls,
        arrays: dict,
        meta: dict,
        *,
        backend: str = "auto",
        device="cuda",
        pattern_key: Union[str, Callable[[], str]] = "",
        a_vals=None,
        b_vals=None,
        a_blocks: Optional[np.ndarray] = None,
        b_blocks: Optional[np.ndarray] = None,
        a_pattern: Optional[COO] = None,
        b_pattern: Optional[COO] = None,
        mesh: Optional[Mesh] = None,
        mesh_axis: Optional[str] = None,
        output: str = "block",
    ) -> "SpGEMMPlan":
        """Build a plan from persisted symbolic artifacts + this call's values.

        ``(arrays, meta)`` is what :meth:`persist_artifacts` returns, here
        or in the JAX package: the triple schedule, the assembly map, the
        compact map (``output="compact"``, which must match the persisted
        output), for element plans the value-scatter indices, and for
        sharded plans the shard bounds. The symbolic phase is **not**
        re-run (``report.schedule_builds == 0``). The values are
        ``a_vals``/``b_vals``, one per persisted scatter index (element
        plans), or ``a_blocks``/``b_blocks`` of the persisted shapes (block
        plans). The persisted backend may
        name the other package's backend and is not read. ``mesh`` gives a
        :class:`ShardedSpGEMMPlan`, partitioned by the persisted shard
        bounds when there are any (their shard count must be the mesh's);
        without ``mesh`` the full schedule makes a single-device plan. Any
        inconsistency between artifacts and inputs raises.
        """
        device = resolve_device(device)
        backend = resolve_backend(backend, device)
        _check_output(output)
        if output == "exact":
            raise _not_served("persistence")
        kind = meta.get("kind")
        if kind not in ("element", "block"):
            raise ValueError(f"unknown persisted plan kind {kind!r}")
        if meta.get("output", "block") != output:
            raise ValueError(
                f"persisted output {meta.get('output', 'block')!r} != {output!r}"
            )
        schedule = schedule_from_arrays(arrays)
        assembly = assembly_from_arrays(arrays)
        compact = (
            assembly_from_arrays(arrays, prefix="casm.") if output == "compact" else None
        )
        a_shape = tuple(int(x) for x in meta["a_shape"])
        b_shape = tuple(int(x) for x in meta["b_shape"])
        out_shape = tuple(int(x) for x in meta["out_shape"])
        tile = tuple(int(x) for x in meta["tile"])
        group = int(meta["group"])
        a_scatter = arrays.get("a_scatter")
        b_scatter = arrays.get("b_scatter")
        # The persisted value dtypes (the JAX package's names).
        a_dtype, b_dtype = (_value_dtype(meta.get(f"{x}_dtype", "float32")) for x in ("a", "b"))

        def element_values(vals, scatter, dtype, name):
            if scatter is None:
                raise ValueError(f"{name}: persisted scatter missing")
            vals = _host_values(vals, dtype)
            if vals.shape != (int(np.asarray(scatter).shape[0]),):
                raise ValueError(
                    f"{name}: {tuple(vals.shape)} values vs persisted scatter "
                    f"of {int(np.asarray(scatter).shape[0])}"
                )
            return vals.clone()  # the plan's own: the caller may reuse its buffer

        if kind == "element":
            if a_vals is None or b_vals is None:
                raise ValueError("element plan needs a_vals/b_vals")
            a_vals = element_values(a_vals, a_scatter, a_dtype, "a_vals")
            b_vals = element_values(b_vals, b_scatter, b_dtype, "b_vals")
            nnz_a, nnz_b = int(a_vals.shape[0]), int(b_vals.shape[0])
        else:
            if a_blocks is None or b_blocks is None:
                raise ValueError("block plan needs a_blocks/b_blocks")
            a_vals = _as_tensor(a_blocks, a_dtype)
            b_vals = _as_tensor(b_blocks, b_dtype)
            if tuple(a_vals.shape) != a_shape:
                raise ValueError(f"a_blocks {a_vals.shape} vs persisted {a_shape}")
            if tuple(b_vals.shape) != b_shape:
                raise ValueError(f"b_blocks {b_vals.shape} vs persisted {b_shape}")
            nnz_a = nnz_b = 0  # bound to the plan's values below (lazy)
        report = _make_report(
            pattern_key, tile, group, backend, out_shape, nnz_a, nnz_b,
            a_shape[0] if len(a_shape) == 3 else 0,
            b_shape[0] if len(b_shape) == 3 else 0, schedule,
        )
        report.schedule_builds = 0
        report.loads = 1
        report.load_hits = 1
        plan_cls, extra = _resolve_plan_cls(mesh, mesh_axis)
        if mesh is not None and "shard_bounds" in arrays:
            extra["shards"] = shards_from_bounds(schedule, arrays["shard_bounds"])
        plan = plan_cls(
            schedule=schedule,
            a_vals=a_vals,
            b_vals=b_vals,
            block_shapes=(a_shape, b_shape),
            value_dtypes=(a_dtype, b_dtype),
            backend=backend,
            device=device,
            out_shape=out_shape,
            report=report,
            a_scatter=None if a_scatter is None else np.asarray(a_scatter),
            b_scatter=None if b_scatter is None else np.asarray(b_scatter),
            a_pattern=a_pattern,
            b_pattern=b_pattern,
            assembly=assembly,
            output=output,
            compact=compact,
            **extra,
        )
        if kind == "block":
            report._nnz_a = _staged_nnz(plan, "a", "nnz_a")
            report._nnz_b = _staged_nnz(plan, "b", "nnz_b")
        tuned_meta = meta.get("tuned_config")
        if tuned_meta is not None:
            # Imported here: the autotuner imports this module.
            from repro_torch.spgemm.autotune import TunedConfig

            plan.apply_tuned_config(
                TunedConfig.from_meta(dict(tuned_meta), source="persisted"))
        return plan

    # -- numeric phase ----------------------------------------------------

    def value_shapes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-set operand shapes the numeric phase accepts:
        ``(want_a, want_b)`` — ``[nnz]`` vectors for element plans, packed
        block arrays for block plans. ``execute_batch`` and ``submit`` take
        the same shapes with a shared leading batch axis."""
        if self.kind == "element":
            return (self.report.nnz_a,), (self.report.nnz_b,)
        return self._a_shape, self._b_shape

    def value_nbytes(self) -> int:
        """Bytes of one request's operand values (``a_vals`` + ``b_vals``
        at the plan's packed dtypes)."""
        want_a, want_b = self.value_shapes()
        return (int(np.prod(want_a)) * self._a_dtype.itemsize
                + int(np.prod(want_b)) * self._b_dtype.itemsize)

    @property
    def value_dtypes(self) -> Tuple[torch.dtype, torch.dtype]:
        """The packed dtypes of A's and B's values: the dtypes of the
        values the plan was built on (float32 or bfloat16), to which every
        rebind rounds."""
        return self._a_dtype, self._b_dtype

    def _empty_csr(self) -> CSR:
        return CSR(
            np.zeros(self._m + 1, np.int64), np.zeros(0, np.int32),
            np.zeros(0, np.float32), (self._m, self._n),
        )

    def _wrap_packed(self, packed: torch.Tensor) -> CSR:
        """Packed C values (active-map order) -> CSR on the precomputed
        structure. indptr/indices are shared across this plan's results;
        the values are each result's own: a fresh page-locked tensor from
        the caching host allocator on the card, ``packed`` itself on the
        host."""
        asm = self._active()
        # The download is the host's wait for the device plus the copy.
        with _copy_span("spgemm.execute.download", "spgemm.d2h_bytes", packed.nbytes):
            host = _collect(_download(packed))
        with span("spgemm.execute.wrap"):
            return CSR(asm.indptr, asm.indices, host.numpy(), (self._m, self._n))

    def output_pattern(self) -> "StructuralPattern":
        """C's value-independent output structure, the seed of the next
        plan in a chain (:func:`plan_from_structural_pattern`): element-
        exact under ``output="compact"``, block-structural (zero fill
        included) under the default block output."""
        asm = self._active()
        return StructuralPattern(asm.indptr, asm.indices, (self._m, self._n))

    def device_indptr(self) -> torch.Tensor:
        """Device-resident CSR ``indptr`` (int32) of the active output map.
        Together with a ``_run_packed`` result this is a complete CSR
        replica of C that never leaves the device."""
        with self._lock:
            ex = self._executor
        if ex is None:
            return torch.from_numpy(self._active().indptr.astype(np.int32)).to(self.device)
        return ex.device_indptr()

    def then(self, b, **kwargs) -> "SpGEMMChain":
        """Compose this plan with a next operand: plan ``C @ b`` from this
        plan's output pattern (no COO conversion of C) and return the
        two-stage :class:`SpGEMMChain`. ``kwargs`` go to
        :func:`plan_from_structural_pattern`; tile, group, backend, device,
        output and the value dtype default to this plan's own."""
        return SpGEMMChain([self, self._plan_next(b, **kwargs)])

    def _plan_next(self, b, **kwargs) -> "SpGEMMPlan":
        if (kwargs.get("output", self.output) == "exact") != (self.output == "exact"):
            raise _mixed_chain()
        kwargs.setdefault("tile", self.report.tile)
        kwargs.setdefault("group", self.report.group)
        kwargs.setdefault("backend", self.backend)
        kwargs.setdefault("device", self.device)
        kwargs.setdefault("output", self.output)
        kwargs.setdefault("dtype", self._a_dtype)
        return plan_from_structural_pattern(self.output_pattern(), b, **kwargs)

    @traced("spgemm.execute")
    def execute(self, a_vals=None, b_vals=None) -> CSR:
        """Numeric phase only: C = A @ B for fresh values on the planned
        pattern. Zero schedule-construction work."""
        packed = self._run_packed(a_vals, b_vals)
        if packed is None:
            return self._empty_csr()
        return self._wrap_packed(packed)

    __call__ = execute

    def _run_packed(self, a_vals=None, b_vals=None) -> Optional[torch.Tensor]:
        """``execute``'s device core: bind the values given, stage on the
        device whichever bound operand is not there yet, run the numeric
        phase and return the packed C values on the device (``None`` for
        an empty plan): the handoff ``execute_chain`` keeps on the device
        between stages."""
        with self._lock:
            self._check_released()
            if a_vals is not None or b_vals is not None:
                with span("spgemm.execute.rebind"):
                    self._bind(a_vals, b_vals)
            # Snapshot under the lock so a concurrent rebind cannot mix one
            # caller's A with another's B.
            a_dev, b_dev = self._staged("execute")
            # The executor too: a release() after this block drops the
            # plan's reference, not the snapshot, so this execute stays
            # correct; None here means an empty plan, never a released one.
            ex = self._executor
            self.report.executes += 1
        if ex is None:
            return None
        with span("spgemm.execute.launch", pairs=ex.pairs):
            return ex.run(a_dev, b_dev)

    def _bind(self, a_vals=None, b_vals=None) -> None:
        """Make ``a_vals`` / ``b_vals`` the plan's bound values; an operand
        passed as ``None`` keeps its own. The one writer of the bound
        values (call under ``self._lock``): each operand is checked against
        :meth:`value_shapes`, rounded to the plan's dtype and copied into a
        tensor the plan owns (the caller may reuse its buffer), by
        :meth:`_own`: a host copy, whose device copy the next run stages,
        or, for a tensor already on a CUDA plan's device, a device copy
        and no host copy. One array passed as both operands is copied, and
        staged, once."""
        want_a, want_b = self.value_shapes()
        a = None if a_vals is None else self._checked(a_vals, want_a, "a_vals", self._a_dtype)
        same = (a is not None and b_vals is a_vals and self._b_dtype == self._a_dtype
                and want_b == want_a)
        b = a if same else None if b_vals is None else self._checked(
            b_vals, want_b, "b_vals", self._b_dtype)
        if a is not None:
            self._a_host, self._a_dev = self._own(a)
        if b is not None:
            self._b_host, self._b_dev = (self._a_host, self._a_dev) if same else self._own(b)

    def _checked(self, vals, want: Tuple[int, ...], name: str,
                 dtype: torch.dtype) -> torch.Tensor:
        """``vals`` as a tensor of the packed ``dtype`` and the shape
        ``want`` (a tensor on a device stays there)."""
        vals = _as_tensor(vals, dtype)
        if tuple(vals.shape) != want:
            if self.kind == "element":
                raise ValueError(
                    f"{name}: expected [{want[0]}] values in canonical pattern "
                    f"order, got shape {tuple(vals.shape)}"
                )
            raise ValueError(
                f"{name}: expected packed blocks of shape {want}, "
                f"got {tuple(vals.shape)}"
            )
        return vals

    def _own(self, vals: torch.Tensor) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``(host copy, device copy)`` of ``vals`` that the plan owns,
        never an alias. A tensor on a CUDA plan's own device is cloned
        there and becomes the device copy, with no host copy, where the
        executor reads values in their value shape; any other becomes a
        host copy, page-locked on the card so that staging it does not
        block the host, and no device copy yet."""
        if vals.device == self.device and self.device.type == "cuda" and self._binds_on_device:
            return None, vals.clone(memory_format=torch.contiguous_format)
        if self.device.type == "cuda" and vals.device.type == "cpu":
            return _pinned_copy(vals), None
        return (vals.contiguous().clone() if vals.device.type == "cpu" else vals.cpu()), None

    def _bound(self, side: str) -> Optional[torch.Tensor]:
        """The bound values of operand ``side`` (``"a"`` or ``"b"``) in its
        value shape, wherever they are: its host copy, else its device
        copy (``None``: released)."""
        host = getattr(self, f"_{side}_host")
        return host if host is not None or not self._binds_on_device \
            else getattr(self, f"_{side}_dev")

    def _copy_back(self) -> None:
        """Give each operand bound from the card a host copy, by one copy
        back into page-locked memory (call under ``self._lock``), for a
        reader that drops the device copies."""
        for side in ("a", "b"):
            host, dev = getattr(self, f"_{side}_host"), getattr(self, f"_{side}_dev")
            if host is None and dev is not None:
                if side == "b" and dev is self._a_dev:
                    self._b_host = self._a_host
                else:
                    setattr(self, f"_{side}_host", _collect(_copy_out(dev)))

    def _staged(self, what: str):
        """The bound values in the executor's device layout, staging the
        operands that have no device copy yet (call under ``self._lock``;
        an empty plan stages nothing). The span ``spgemm.execute.upload``
        and the counter ``spgemm.h2d_bytes`` count the bytes copied."""
        if self._bound("a") is None or self._bound("b") is None:
            raise ValueError(
                f"plan values were released (release_values); pass "
                f"a_vals/b_vals to {what}"
            )
        a = self._a_host if self._a_dev is None else None
        b = self._b_host if self._b_dev is None else None
        nbytes = (0 if a is None else a.nbytes) + (0 if b is None or b is a else b.nbytes)
        with _copy_span("spgemm.execute.upload", "spgemm.h2d_bytes", nbytes):
            if self._executor is not None and (a is not None or b is not None):
                a_dev, b_dev = self._executor.stage(a, b)
                if a is not None:
                    self._a_dev = a_dev
                if b is not None:
                    self._b_dev = b_dev
        return self._a_dev, self._b_dev

    def _run_packed_chained(self, c_packed: Optional[torch.Tensor],
                            stage: int = 2) -> Optional[torch.Tensor]:
        """Stage ``stage`` (from 2) of :func:`execute_chain`: the previous
        stage's packed C values (active-map order, which is canonical
        element order) are this plan's A values, bound on the device and
        rounded to this plan's A dtype; B values are the plan's own, copied
        to the device once and reused across chain executes. The span
        ``spgemm.chain.launch`` covers the bind and the launch."""
        if self.kind != "element":
            raise ValueError(
                "chained stages need element plans (built from COO/CSR "
                "inputs or plan_from_structural_pattern)"
            )
        with self._lock:
            self._check_released()
            if self._b_vals_dev is None:
                if self.b_pattern is None:
                    raise ValueError(
                        "chained stage has no B values: the plan was built "
                        "without a B pattern; rebuild it via "
                        "plan_from_structural_pattern with B in hand"
                    )
                self._b_vals_dev = _device_values(self.b_pattern.val, self.device,
                                                  self._b_dtype)
            b_dev = self._b_vals_dev
            ex = self._executor  # snapshot: see _run_packed
            self.report.executes += 1
        if c_packed is None:  # previous stage was empty: A values all zero
            c_packed = torch.zeros(self.report.nnz_a, dtype=self._a_dtype, device=self.device)
        if tuple(c_packed.shape) != (self.report.nnz_a,):
            raise ValueError(
                f"chained values: expected [{self.report.nnz_a}] from the "
                f"previous stage, got shape {tuple(c_packed.shape)}"
            )
        if ex is None:
            return None
        with span("spgemm.chain.launch", pairs=ex.pairs, stage=stage):
            return ex.run(c_packed.to(self._a_dtype), b_dev)

    def execute_batch(self, a_vals, b_vals) -> list:
        """Batched numeric phase over a leading value-batch axis.

        ``a_vals`` is ``[batch, nnz_a]`` for element plans or
        ``[batch, nnzb_a, bm, bk]`` packed blocks for block plans
        (``b_vals`` likewise). Returns a list of ``batch`` CSR results that
        share this plan's precomputed ``indptr``/``indices``, each
        bitwise-equal to ``execute`` on the same values.

        Stateless with respect to the plan's staged values: it never
        touches the buffers no-arg ``execute()`` reuses, so it works after
        ``release_values()``. Values are rounded to the plan's packed
        dtypes, as ``execute`` rounds them.
        """
        if not isinstance(a_vals, torch.Tensor):
            a_vals = np.asarray(a_vals)
        if not isinstance(b_vals, torch.Tensor):
            b_vals = np.asarray(b_vals)
        want_a, want_b = self.value_shapes()
        a_shape = tuple(a_vals.shape)
        b_shape = tuple(b_vals.shape)
        if len(a_shape) != len(want_a) + 1 or a_shape[1:] != want_a:
            raise ValueError(
                f"a_vals: expected [batch, {', '.join(map(str, want_a))}], "
                f"got shape {a_shape}"
            )
        if b_shape[1:] != want_b or b_shape[0] != a_shape[0]:
            raise ValueError(
                f"b_vals: expected [{a_shape[0]}, "
                f"{', '.join(map(str, want_b))}], got shape {b_shape}"
            )
        batch = int(a_shape[0])
        with self._lock:
            self._check_released()
            ex = self._executor  # snapshot: see _run_packed
            self.report.executes += batch
        if batch == 0:
            return []
        if ex is None:
            return [self._empty_csr() for _ in range(batch)]
        # Oversized batches are split (SpGEMMExecutor.batch_chunk); each
        # chunk is still one fused device call.
        chunk = min(batch, ex.batch_chunk())
        out = []
        for lo in range(0, batch, chunk):
            hi = min(lo + chunk, batch)
            packed = _collect(_download(ex.run_batch(
                _device_values(a_vals[lo:hi], self.device, self._a_dtype),
                _device_values(b_vals[lo:hi], self.device, self._b_dtype),
            )))
            out.extend(self._wrap_packed(packed[i]) for i in range(hi - lo))
        return out

    # -- asynchronous serving (the stage-split pipeline surface) ----------

    def pipeline(self, depth: Optional[int] = None) -> SpGEMMPipeline:
        """A bounded-depth submit/collect pipeline over this plan;
        ``depth=None`` takes the tuned depth of an applied
        :class:`TunedConfig`, else 2, the paper's double buffer (one step
        copying while one computes). See
        :class:`repro_torch.spgemm.pipeline.SpGEMMPipeline`."""
        return SpGEMMPipeline(self, depth=self._default_depth() if depth is None else depth)

    def execute_async(self, a_vals=None, b_vals=None) -> SpGEMMTicket:
        """Dispatch one numeric phase without blocking; redeem the returned
        ticket with ``.result()``. Same operand shapes as ``execute`` (a
        leading batch axis makes the ticket redeem to ``execute_batch``'s
        list of CSRs). Each call is its own depth-1 pipeline; use
        :meth:`pipeline` for bounded-depth serving."""
        return SpGEMMPipeline(self, depth=1).submit(a_vals, b_vals)

    def execute_stream(self, value_iter, *, depth: Optional[int] = None):
        """Stream value sets through a ``depth``-deep pipeline (``None``:
        the tuned depth, else 2), yielding one CSR per item in order. ``value_iter`` yields
        ``(a_vals, b_vals)`` tuples or ``{"a_vals", "b_vals"}`` dicts, e.g.
        :meth:`repro_torch.data.pipeline.SpGEMMValueStream.value_iter`.
        Results are bitwise-equal to calling ``execute`` per item."""
        return self.pipeline(depth).stream(value_iter)

    @property
    def in_flight(self) -> int:
        """Pipeline steps submitted against this plan and not yet
        collected (or discarded). Buffer teardown refuses while > 0."""
        with self._lock:
            return self._inflight

    def _check_released(self) -> None:
        """Call under ``self._lock``."""
        if self._released:
            raise RuntimeError(
                "plan was released (release()); build a new plan"
            )

    def _check_no_inflight(self, what: str) -> None:
        """Call under ``self._lock``."""
        if self._inflight:
            raise RuntimeError(
                f"cannot {what}: {self._inflight} in-flight pipeline "
                f"step(s) still read this plan's staged buffers; collect "
                f"the tickets or close the pipeline first"
            )

    def _pipe_streams(self, depth: int) -> list:
        """``depth`` side streams for a pipeline's slots: the plan's first
        ``depth`` CUDA streams (None on the CPU). Pipelines over one plan
        share them; work on a shared stream is ordered, never mixed."""
        if self.device.type != "cuda":
            return [None] * depth
        with self._lock:
            while len(self._streams) < depth:
                self._streams.append(torch.cuda.Stream(self.device))
            return self._streams[:depth]

    def _pipe_operand(self, vals, dtype: torch.dtype) -> torch.Tensor:
        """One submitted operand in the plan's value dtype: a tensor on a
        CUDA plan's device stays there; anything else becomes a host
        tensor, page-locked on a CUDA plan so that its copy to the card
        is asynchronous (a fresh copy: the caller may reuse its buffer)."""
        if self.device.type == "cuda":
            if isinstance(vals, torch.Tensor) and vals.device == self.device:
                return _as_tensor(vals, dtype).contiguous()
            return _pinned_copy(_host_values(vals, dtype))
        return _host_values(vals, dtype)

    def _pipe_check(self, a_vals, b_vals) -> _Prepared:
        """Validate one submission and prepare its operands (host work and
        a plan-state snapshot; no device compute is enqueued).

        Stateless with respect to the plan's staged values, except that
        the no-arg form stages (and caches) the plan's own values exactly
        like ``execute()`` does."""
        if (a_vals is None) != (b_vals is None):
            raise ValueError(
                "submit takes both a_vals and b_vals, or neither "
                "(to reuse the plan's staged values)"
            )
        if a_vals is None:
            with self._lock:
                self._check_released()
                a_dev, b_dev = self._staged("submit")
                return _Prepared(a_dev, b_dev, None, 1, self._executor)
        with self._lock:
            self._check_released()
            # The step's executor, taken with the released check (see
            # _run_packed); _pipe_begin checks again before dispatch.
            ex = self._executor
        if not isinstance(a_vals, torch.Tensor):
            a_vals = np.asarray(a_vals)
        if not isinstance(b_vals, torch.Tensor):
            b_vals = np.asarray(b_vals)
        want_a, want_b = self.value_shapes()
        a_shape, b_shape = tuple(a_vals.shape), tuple(b_vals.shape)
        single = a_shape == want_a and b_shape == want_b
        batched = (
            len(a_shape) == len(want_a) + 1 and a_shape[1:] == want_a
            and b_shape[:1] == a_shape[:1] and b_shape[1:] == want_b
        )
        if not (single or batched):
            raise ValueError(
                f"submit: expected a_vals {want_a} / b_vals {want_b} "
                f"(optionally with a shared leading batch axis), got "
                f"{a_shape} / {b_shape}"
            )
        a = self._pipe_operand(a_vals, self._a_dtype)
        b = self._pipe_operand(b_vals, self._b_dtype)
        if single:
            return _Prepared(a, b, None, 1, ex)
        batch = int(a_shape[0])
        return _Prepared(a, b, batch, batch, ex)

    def _pipe_begin(self, n_execs: int) -> None:
        with self._lock:
            self._check_released()
            self.report.executes += n_execs
            self._inflight += 1

    def _pipe_end(self) -> None:
        with self._lock:
            self._inflight -= 1

    def _pipe_dispatch(self, prep: _Prepared, stream=None):
        """Enqueue one prepared step's device work (copy in, rebind,
        kernel, assembly, copy out) without blocking; returns the pending
        result (a list of per-chunk results for batch submissions).

        On a CUDA plan the work goes to ``stream``, which first waits for
        the caller's current stream (the plan's constants and any device
        operands were made there); every tensor the step reads that
        another stream made is marked with ``record_stream``, so its
        memory is not reused while the step may still read it. On the CPU
        (``stream=None``) the step runs at once."""
        if prep.executor is None or prep.batch == 0:
            return None
        if stream is None:
            return self._pipe_run(prep)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in _tensors(prep.executor.constants() + [prep.a, prep.b]):
            if t.device == stream.device:
                t.record_stream(stream)
        with torch.cuda.stream(stream):
            return self._pipe_run(prep)

    def _pipe_run(self, prep: _Prepared):
        ex = prep.executor
        if prep.batch is None:
            return _download(ex.run(prep.a, prep.b))
        # Batch submissions chunk exactly like execute_batch; the chunks
        # are enqueued back to back.
        chunk = min(prep.batch, ex.batch_chunk())
        return [_download(ex.run_batch(prep.a[lo:lo + chunk], prep.b[lo:lo + chunk]))
                for lo in range(0, prep.batch, chunk)]

    def _pipe_collect(self, prep: _Prepared, packed):
        """Wait for one dispatched step and wrap it in the plan's
        precomputed CSR structure."""
        ex = prep.executor
        if prep.batch is None:
            if ex is None:
                return self._empty_csr()
            return self._wrap_packed(_collect(packed))
        if ex is None:
            return [self._empty_csr() for _ in range(prep.batch)]
        out = []
        for chunk_packed in (packed or ()):
            arr = _collect(chunk_packed)
            out.extend(self._wrap_packed(arr[i]) for i in range(arr.shape[0]))
        return out

    # -- teardown ----------------------------------------------------------

    def release_device_values(self) -> None:
        """Drop only the staged device copies of the values; the next
        execute restages from the host copies (an operand bound from the
        card is copied back once first). Refuses while pipeline steps are
        in flight."""
        with self._lock:
            self._check_no_inflight("release device values")
            self._copy_back()
            self._a_dev = None
            self._b_dev = None
            self._b_vals_dev = None

    def release_values(self) -> None:
        """Drop the host and device copies of the values, so that a plan
        kept for its pattern pins no operand-sized memory. Afterwards
        ``execute`` needs explicit ``a_vals``/``b_vals``
        (``execute_batch`` never reads staged values). Refuses while
        pipeline steps are in flight."""
        with self._lock:
            self._check_no_inflight("release values")
            self._a_host = self._b_host = None
            self._a_dev = self._b_dev = self._b_vals_dev = None

    def release(self) -> None:
        """Full teardown: values (host and device) and the executor's
        device constants. The plan is dead afterwards: every execute or
        submit raises, and it evicts itself from the cache that holds it,
        so the next ``spgemm_plan`` for this pattern builds (or loads from
        disk) a fresh plan instead of hitting the dead one. Refuses while
        pipeline steps are in flight; drain or ``close()`` pipelines
        first."""
        with self._lock:
            self._check_no_inflight("release plan")
            self._released = True
            self._a_host = self._b_host = None
            self._a_dev = self._b_dev = self._b_vals_dev = None
            self._executor = None
            ref = self._cache_ref
        # Self-evict outside the plan lock: the cache takes its own lock
        # first and then reads in_flight under this plan's (cache, then
        # plan, always). in_flight is 0 and submits now refuse, so the
        # guarded evict cannot race back to RuntimeError.
        if ref is not None:
            cache = ref[0]()
            if cache is not None:
                cache.evict(ref[1], only=self)

    def host_nbytes(self) -> int:
        """Approximate bytes of host arrays this plan retains (values bound
        from the card and held there only count none)."""
        sch = self.schedule
        arrays = [
            sch.a_slot, sch.b_slot, sch.panel, sch.sub_row, sch.start,
            sch.panel_group, sch.panel_bcol, sch.c_brow, sch.c_bcol,
            self._a_scatter, self._b_scatter,
        ]
        for pat in (self.a_pattern, self.b_pattern):
            if pat is not None:
                arrays += [pat.row, pat.col, pat.val]
        with self._lock:
            values = {id(t): t for t in (self._a_host, self._b_host) if t is not None}
        compact = self.compact.nbytes() if self.compact is not None else 0
        return (self.assembly.nbytes() + compact
                + sum(a.nbytes for a in arrays if a is not None)
                + sum(t.nbytes for t in values.values()))


class ShardedSpGEMMPlan(SpGEMMPlan):
    """A mesh-aware :class:`SpGEMMPlan`: the panel schedule is partitioned
    across the devices of one mesh axis, one program per shard.

    Construction (``spgemm_plan(..., mesh=...)``) partitions the symbolic
    schedule at block-row-group boundaries balanced by **triple count**
    (:func:`~repro_torch.core.schedule.partition_spgemm_schedule`), builds
    each shard's own :class:`~repro_torch.core.schedule.AssemblyMap` slice
    (and compact slice), and stages each shard's schedule and gather map
    on its device, B once per distinct device
    (:class:`~repro_torch.spgemm.executor.ShardedSpGEMMExecutor`).
    ``execute`` / ``execute_batch`` / the pipeline keep the single-device
    semantics and output: C's per-shard segments are contiguous row
    ranges, so the packed C is their concatenation along the precomputed
    indptr bounds, and it equals the single-device plan's bitwise. The
    plan's ``device`` is the mesh's first device: operands arrive there
    and C is assembled there.
    """

    def __init__(
        self,
        *,
        mesh: Mesh,
        mesh_axis: Optional[str] = None,
        shards: Optional[list] = None,
        **kw,
    ):
        if not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a repro_torch.launch.mesh.Mesh "
                f"(make_shard_mesh), got {type(mesh).__name__}"
            )
        if mesh_axis is None:
            mesh_axis = mesh.axis_names[0]
        if mesh_axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {mesh_axis!r}: {mesh.axis_names}")
        if kw.get("output") == "exact":
            raise _not_served("sharded plans (mesh=)")
        asked = torch.device(kw.get("device", "cuda"))
        if asked.type != mesh.devices[0].type:
            raise ValueError(
                f"plan device {asked} and mesh devices {mesh.devices[0].type} differ"
            )
        kw["device"] = mesh.devices[0]
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.n_shards = int(mesh.shape[mesh_axis])
        # ``shards`` is the persistence seam: a rehydrated plan passes the
        # deserialized partition so _make_executor skips the partitioner
        # along with the rest of the symbolic phase.
        self._preloaded_shards = shards
        self._shards: List[ScheduleShard] = []
        self._shard_assemblies: List[AssemblyMap] = []
        self._shard_compacts: List[AssemblyMap] = []
        super().__init__(**kw)

    _assembles_on_device = False
    _binds_on_device = False

    def _make_executor(self, gather=None):
        if self._preloaded_shards is not None:
            if len(self._preloaded_shards) != self.n_shards:
                raise ValueError(
                    f"{len(self._preloaded_shards)} persisted shards for a "
                    f"{self.n_shards}-device mesh axis"
                )
            self._shards = self._preloaded_shards
        else:
            self._shards = partition_spgemm_schedule(self.schedule, self.n_shards)
        bm, bn, g = self._bm, self._bn, self._group
        spans = [(min(sh.group_lo * g * bm, self._m), min(sh.group_hi * g * bm, self._m))
                 for sh in self._shards]
        for sh, (row_lo, row_hi) in zip(self._shards, spans):
            self._shard_assemblies.append(build_assembly_map(
                sh.schedule, (bm, bn), (row_hi - row_lo, self._n)))
        if sum(a.nnz for a in self._shard_assemblies) != self.assembly.nnz:
            raise AssertionError("shard assembly slices do not cover the plan assembly")
        # Compact output: each shard gathers through its slice of the
        # element-exact pattern (a subset of its block map, rows rebased to
        # the shard); shard row ranges are contiguous, so the plan-wide
        # compact rows split into per-shard runs by searchsorted.
        active = self._shard_assemblies
        if self.output == "compact":
            rows_c = np.repeat(np.arange(self._m, dtype=np.int64),
                               np.diff(self.compact.indptr))
            for asm, (row_lo, row_hi) in zip(self._shard_assemblies, spans):
                lo, hi = np.searchsorted(rows_c, [row_lo, row_hi])
                self._shard_compacts.append(build_compact_map(
                    asm, rows_c[lo:hi] - row_lo, self.compact.indices[lo:hi]))
            if sum(a.nnz for a in self._shard_compacts) != self.compact.nnz:
                raise AssertionError("shard compact slices do not cover the compact map")
            active = self._shard_compacts
        a_val_bounds = None
        if self.kind == "element":
            if self.a_pattern is None:
                raise ValueError("a sharded element plan needs its A pattern")
            # Element values are canonical row-major and shards own
            # contiguous row ranges: each shard's A values are one slice.
            a_val_bounds = np.concatenate([
                np.searchsorted(self.a_pattern.row, [lo for lo, _ in spans]),
                [self.a_pattern.nnz],
            ]).astype(np.int64)
        return ShardedSpGEMMExecutor(
            shards=self._shards,
            assemblies=active,
            devices=self.mesh.devices,
            backend=self.backend,
            a_scatter=self._a_scatter,
            b_scatter=self._b_scatter,
            a_shape=self._a_shape,
            b_shape=self._b_shape,
            a_val_bounds=a_val_bounds,
        )

    def shard_stats(self) -> dict:
        """Per-shard load profile: triple, panel and output-value counts,
        and the max/mean triple-count imbalance the partitioner reached."""
        triples = [sh.num_triples for sh in self._shards]
        mean = sum(triples) / max(len(triples), 1)
        return {
            "n_shards": self.n_shards,
            "mesh_axis": self.mesh_axis,
            "triples": triples,
            "panels": [sh.n_panels for sh in self._shards],
            "nnz_c": [a.nnz for a in self._shard_assemblies],
            "imbalance": (max(triples) / mean) if mean else 0.0,
        }

    def host_nbytes(self) -> int:
        return super().host_nbytes() + sum(
            a.nbytes() for a in self._shard_assemblies + self._shard_compacts)

    def persist_artifacts(self) -> Tuple[dict, dict]:
        """Adds the shard partition to the base artifacts: the group-bound
        vector alone rebuilds every :class:`ScheduleShard` slice bitwise
        (:func:`repro_torch.core.schedule.shards_from_bounds`). Empty plans
        (no executor, no shards) persist without bounds and re-partition
        on load."""
        arrays, meta = super().persist_artifacts()
        if self._shards:
            arrays["shard_bounds"] = shards_to_bounds(self._shards)
        meta["n_shards"] = self.n_shards
        meta["mesh_axis"] = self.mesh_axis
        return arrays, meta


def _tensors(items):
    """The tensors in a list of tensors, staged shard lists (``None`` for
    nothing) and per-device dicts."""
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            yield from _tensors(x.values())
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _resolve_plan_cls(mesh: Optional[Mesh], mesh_axis: Optional[str]):
    """(plan class, extra constructor kwargs) for an optional mesh."""
    if mesh is None:
        if mesh_axis is not None:
            raise ValueError("mesh_axis without a mesh")
        return SpGEMMPlan, {}
    return ShardedSpGEMMPlan, {"mesh": mesh, "mesh_axis": mesh_axis}


def _mesh_key(mesh: Optional[Mesh], mesh_axis: Optional[str]):
    """Cache-key component for the shard axis: sharded plans stage their
    constants on concrete devices, so the key pins the axis name, the
    shard count and the device list, repeats included. ``None`` for
    single-device plans."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch.launch.mesh.Mesh (make_shard_mesh), "
            f"got {type(mesh).__name__}"
        )
    axis = mesh_axis if mesh_axis is not None else mesh.axis_names[0]
    return (axis, mesh.size, tuple(str(d) for d in mesh.devices))


def _plan_device(device, mesh: Optional[Mesh]) -> torch.device:
    """The device a plan stages on: a sharded plan's is its mesh's first
    (whose type must be the asked device's)."""
    if mesh is None or not isinstance(mesh, Mesh):
        return resolve_device(device)
    if torch.device(device).type != mesh.devices[0].type:
        raise ValueError(f"plan device {device} and mesh devices {mesh.devices[0].type} differ")
    return mesh.devices[0]


def _input_dtype_name(x) -> Optional[str]:
    """The value dtype name of a plan input (``"bfloat16"``, ``"float32"``,
    ``"float64"``...), or ``None`` if unreadable."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    v = getattr(x, "val", None)  # COO/CSR/CSC/CSV
    if v is None:
        v = getattr(x, "blocks", None)  # BCSV/BCSR
    if v is None and isinstance(x, np.ndarray):
        v = x
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return np.asarray(v).dtype.name


def _cache_check(cache) -> PlanCache:
    if cache is None:
        return default_cache()
    if not isinstance(cache, PlanCache):
        raise TypeError(
            f"cache must be a repro_torch.spgemm.cache.PlanCache, got {type(cache).__name__}"
        )
    return cache


def _check_output(output: str) -> None:
    if output not in ("block", "compact", "exact"):
        raise ValueError(f"output must be 'block', 'compact' or 'exact', got {output!r}")


def _staged_nnz(plan: SpGEMMPlan, side: str, field: str):
    """Lazy element-count resolver reading the plan's bound blocks of
    ``side`` (``"a"`` or ``"b"``), host or device copy."""
    def resolve() -> int:
        blocks = plan._bound(side)
        if blocks is None:
            raise ValueError(
                f"{field}: plan values were released before the lazy "
                f"report field was read"
            )
        return int(torch.count_nonzero(blocks))

    return resolve


def _make_report(
    pattern_key, tile, group, backend, shape, nnz_a, nnz_b, nnzb_a, nnzb_b,
    schedule: SpGEMMSchedule,
) -> PlanReport:
    return PlanReport(
        pattern_key=pattern_key,
        tile=tuple(tile),
        group=group,
        backend=backend,
        shape=shape,
        nnz_a=nnz_a,
        nnz_b=nnz_b,
        nnzb_a=nnzb_a,
        nnzb_b=nnzb_b,
        nnzb_c=schedule.nnzb_c,
        num_triples=schedule.num_triples,
        n_panels=schedule.n_panels,
        b_fetches=schedule.b_fetches(),
        block_omar=schedule.block_omar(),
        # An operator env override beats everything (resolve_chunk_bytes);
        # the report says so up front rather than claiming "default".
        config_source=(
            "env-override" if os.environ.get(CHUNK_BYTES_ENV) else "default"
        ),
    )


def _block_pattern_key(a: BCSV, b: BCSR) -> str:
    return pattern_digest(
        a.brow, a.bcol, a.group_ptr, b.indptr, b.indices,
        meta=("blocks", a.shape, b.shape, a.block_shape, b.block_shape,
              a.group, str(a.blocks.dtype), str(b.blocks.dtype)),
    )


def _normalize_tile(tile: Union[int, Tuple[int, ...]]) -> Tuple[int, int, int]:
    if isinstance(tile, int):
        return (tile, tile, tile)
    tile = tuple(int(t) for t in tile)
    if len(tile) == 2:
        return (tile[0], tile[1], tile[1])
    if len(tile) != 3:
        raise ValueError(f"tile must be int, (bm, bk) or (bm, bk, bn); got {tile}")
    return tile


def _canonical_coo(coo: COO) -> Tuple[COO, bool]:
    """``coo`` in canonical row-major order, with arrays of its own, and
    whether it took the sort. The COO equals ``coo.sum_duplicates()``,
    dtypes included; one already strictly ascending in (row, col) skips
    that sort and is copied, a linear pass where the sort is not."""
    if not _coo_is_canonical(coo):
        return coo.sum_duplicates(), True
    # 0 + v, as sum_duplicates' np.add.at computes it: -0.0 becomes +0.0.
    val = np.zeros_like(coo.val)
    val += coo.val
    return COO(coo.row.copy(), coo.col.copy(), val, coo.shape), False


def _canonical_operands(a, b) -> Tuple[COO, COO, int]:
    """Both operands as canonical COOs (:func:`_canonical_coo`), and how
    many took the sort. One operand passed twice, as the same input or as
    two COOs over the same arrays and shape, is canonicalized once and
    shared by both sides."""
    a_coo = to_coo(a)
    b_coo = a_coo if b is a else to_coo(b)
    a_c, a_sorted = _canonical_coo(a_coo)
    if b_coo is a_coo or (b_coo.row is a_coo.row and b_coo.col is a_coo.col
                          and b_coo.val is a_coo.val
                          and tuple(b_coo.shape) == tuple(a_coo.shape)):
        return a_c, a_c, int(a_sorted)
    b_c, b_sorted = _canonical_coo(b_coo)
    return a_c, b_c, int(a_sorted) + int(b_sorted)


def _check_validate(validate) -> None:
    if validate not in (None, "deep"):
        raise ValueError(f"validate must be None or 'deep', got {validate!r}")


def _deep_verify(plan: SpGEMMPlan, validate, verified: Optional[list] = None) -> SpGEMMPlan:
    """``validate="deep"``: run the full static verifier on ``plan``
    (:func:`repro_torch.analysis.verify.verify_plan`) and return it.
    ``verified`` lists the plans one call has verified already (a loader's
    plan is not verified twice); the plan is added to it.

    Raises :class:`~repro_torch.analysis.verify.PlanVerificationError` (an
    ``AssertionError``) when any invariant fails. Called *inside* a
    disk-rehydrate loader, the raise is taken by the cache's loader
    fallback (``load_failures``) and the plan is rebuilt symbolically: a
    corrupted-but-digest-valid artifact fails verification and never
    reaches the kernel. Called on a fresh build or a memory hit, the raise
    propagates to the caller."""
    if validate == "deep" and not any(p is plan for p in verified or ()):
        from repro_torch.analysis.verify import verify_plan

        plan.report.verify_report = verify_plan(plan).raise_if_failed()
        if verified is not None:
            verified.append(plan)
    return plan


def _loaded_block_plan(arrays, meta, a: BCSV, b: BCSR, *, backend, device, pattern_key,
                       mesh, mesh_axis, output, validate=None,
                       verified: Optional[list] = None) -> SpGEMMPlan:
    """Block-path disk rehydrate: the persisted symbolic artifacts with
    this call's packed blocks as the values (verified under
    ``validate="deep"``)."""
    return _deep_verify(SpGEMMPlan.from_artifacts(
        arrays, meta, backend=backend, device=device, pattern_key=pattern_key,
        a_blocks=a.blocks, b_blocks=b.blocks, mesh=mesh, mesh_axis=mesh_axis,
        output=output,
    ), validate, verified)


def _token_disk_loader(a, b, backend, device, mesh, mesh_axis, output="block", validate=None,
                       verified: Optional[list] = None):
    """The loader :meth:`PlanCache.token_disk_get` rehydrates through.

    The disk alias exists to skip the pattern digest, so the loader checks
    this call's operands against the *persisted* meta instead: value dtypes
    must match exactly (``from_artifacts`` would silently round), input
    types must match the persisted plan kind, and ``from_artifacts``
    itself re-checks element counts and block geometry. Any mismatch
    raises, which the cache counts as a load failure; the caller then
    takes the digest path, which settles conflicts explicitly. So does a
    plan that fails ``validate="deep"``.
    """

    def load(key: Tuple, arrays: dict, meta: dict) -> SpGEMMPlan:
        kind = meta.get("kind")
        if (_input_dtype_name(a) != meta.get("a_dtype")
                or _input_dtype_name(b) != meta.get("b_dtype")):
            raise ValueError("value dtype differs from the persisted plan")
        if kind == "element" and isinstance(a, COO) and isinstance(b, COO):
            a_c, b_c, _ = _canonical_operands(a, b)
            plan = SpGEMMPlan.from_artifacts(
                arrays, meta, backend=backend, device=device, pattern_key=key[0],
                a_vals=a_c.val, b_vals=b_c.val, a_pattern=a_c, b_pattern=b_c,
                mesh=mesh, mesh_axis=mesh_axis, output=output,
            )
        elif kind == "block" and isinstance(a, BCSV) and isinstance(b, BCSR):
            plan = _loaded_block_plan(arrays, meta, a, b, backend=backend, device=device,
                                      pattern_key=key[0], mesh=mesh, mesh_axis=mesh_axis,
                                      output=output)
        else:
            raise ValueError(
                f"input types {type(a).__name__}/{type(b).__name__} do not match "
                f"persisted plan kind {kind!r}"
            )
        plan._input_dtypes = (_input_dtype_name(a), _input_dtype_name(b))
        return _deep_verify(plan, validate, verified)

    return load


def _token_values(plan: SpGEMMPlan, a, b, pattern_token) -> Tuple:
    """The values a call brings to a plan found by its pattern token: COO
    inputs' for element plans (canonical order verified, and restored by
    a sort only when needed), BCSV/BCSR inputs' blocks for block plans,
    ``(None, None)`` for a pure lookup (``a = b = None``). Any other input
    type raises: it would silently keep the previous caller's values."""
    if a is None and b is None:
        return None, None
    if plan.kind == "element" and isinstance(a, COO) and isinstance(b, COO):
        a_c, b_c, _ = _canonical_operands(a, b)
        if a_c.nnz != plan.report.nnz_a or b_c.nnz != plan.report.nnz_b:
            raise ValueError(
                f"pattern_token {pattern_token!r}: input nnz ({a_c.nnz}, {b_c.nnz}) "
                f"does not match the token's plan ({plan.report.nnz_a}, "
                f"{plan.report.nnz_b}); the token must name this exact sparsity pattern"
            )
        return a_c.val, b_c.val
    if plan.kind == "block" and isinstance(a, BCSV) and isinstance(b, BCSR):
        if (tuple(a.blocks.shape) != plan._a_shape
                or tuple(b.blocks.shape) != plan._b_shape):
            raise ValueError(
                f"pattern_token {pattern_token!r}: packed block shapes "
                f"{tuple(a.blocks.shape)}/{tuple(b.blocks.shape)} do not match the "
                f"token's plan {plan._a_shape}/{plan._b_shape}"
            )
        return a.blocks, b.blocks
    raise ValueError(
        f"pattern_token {pattern_token!r}: the token fast path rebinds values "
        f"only for COO (element plans) or BCSV/BCSR (block plans) inputs, or "
        f"a=b=None for a pure lookup; got {type(a).__name__}/{type(b).__name__}"
        f" — drop pattern_token to take the full conversion path"
    )


def _served(plan: SpGEMMPlan, cache: PlanCache, hit: bool, vals=(None, None), *,
            validate=None, verified: Optional[list] = None, dtype_names=None,
            token: Optional[Tuple] = None) -> SpGEMMPlan:
    """The end of every path by which :func:`spgemm_plan` and
    :func:`plan_from_structural_pattern` return a plan: record the input
    dtypes and bind the pattern token ``token = (token key, plan key,
    token)`` (when given), take the cache's stats, and on a hit count it
    and bind this call's values ``vals`` (``(a_vals, b_vals)``, ``None``
    for an operand that keeps its own); then ``validate="deep"``."""
    if dtype_names is not None:
        plan._input_dtypes = dtype_names
    if token is not None:
        token_key, key, pattern_token = token
        cache.token_bind(token_key, key)
        plan.report.pattern_token = str(pattern_token)
    plan.report.cache_stats = cache.stats()
    if hit:
        with plan._lock:
            plan.report.cache_hits += 1
            plan._bind(*vals)
    return _deep_verify(plan, validate, verified)


def _dtype_mismatch(plan: SpGEMMPlan, a, b) -> bool:
    """True when a token's plan was built for other value dtypes than
    ``a``/``b`` carry: such a request must not be served (and rounded)
    through the token."""
    want = plan._input_dtypes
    if want is None:
        return False
    return any(got is not None and got != w
               for got, w in zip((_input_dtype_name(a), _input_dtype_name(b)), want))


@traced("spgemm.plan")
def spgemm_plan(
    a,
    b,
    *,
    tile: Union[int, Tuple[int, ...]] = 64,
    group: int = 4,
    backend: str = "auto",
    device="cuda",
    cache: Optional[PlanCache] = None,
    mesh: Optional[Mesh] = None,
    mesh_axis: Optional[str] = None,
    pattern_token: Optional[str] = None,
    autotune: Union[bool, dict, None] = None,
    validate: Optional[str] = None,
    output: str = "block",
) -> SpGEMMPlan:
    """Build — or fetch from the plan cache — an :class:`SpGEMMPlan` for
    ``C = a @ b``.

    ``a``/``b`` may be dense numpy arrays, any element-level sparse format
    (COO/CSR/CSC/CSV), pre-converted BCSV/BCSR blocks (in which case
    ``tile``/``group`` are taken from the formats themselves), or torch
    tensors (dense, sparse COO or sparse CSR). The plan keeps the packed
    dtype of the values: bfloat16 for bfloat16 values (a numpy array of
    dtype ``bfloat16`` or a bfloat16 tensor), float32 for any other. All
    symbolic work happens here, once per distinct ``(pattern, value
    dtypes, tile, group, backend, device, mesh shard axis, output)``.

    ``device="cuda"`` (the default) runs the numeric phase through the
    CUDA kernel and raises when no CUDA device is present;
    ``device="cpu"`` runs the plain PyTorch version.

    ``cache`` is a :class:`~repro_torch.spgemm.cache.PlanCache` (default:
    the process-level :func:`~repro_torch.spgemm.cache.default_cache`,
    whose disk tier ``REPRO_TORCH_SPGEMM_PLAN_DIR`` enables). A memory hit
    returns the same plan object with this call's values rebound; a disk
    hit rehydrates the persisted symbolic artifacts
    (``report.schedule_builds == 0``, ``report.loads == 1``); a fresh
    build is written back to the disk tier.

    ``mesh`` (:func:`repro_torch.launch.mesh.make_shard_mesh`) gives a
    :class:`ShardedSpGEMMPlan` whose panel schedule is partitioned over
    ``mesh_axis`` (default: the mesh's only axis); the device must be of
    the mesh devices' type.

    ``pattern_token`` is the serving warm path's fast key: a caller's name
    for the sparsity pattern. On a cache hit the token resolves the plan
    directly — no ``to_coo`` canonicalization, no pattern digest. The
    token is the caller's *claim* of pattern equality: it is checked
    against the digest whenever both are present (binding one token to two
    different patterns or configurations raises), and echoed in
    ``report.pattern_token``. On a token hit, values are rebound for COO
    inputs (element plans) and BCSV/BCSR inputs (block plans); any other
    input type raises. A value-dtype mismatch never hits the token: it
    falls through to the digest path, which raises the token conflict.
    ``a=None, b=None`` with a token is a pure lookup (``KeyError`` on a
    miss). With the disk tier, a token miss with operands in hand also
    consults the store's persisted alias index: a restarted worker's first
    call resolves token -> key -> disk artifacts without paying the
    digest (``stats.token_disk_hits``).

    ``output="compact"`` makes results store only C's element-exact
    structural nonzeros (no block fill): the plan also builds the compact
    gather map (``plan.compact``), a subset of the block map's positions.
    Compact plans live under their own cache keys (the base key suffixed
    ``"compact"``).

    ``output="exact"`` computes C at element granularity, with no blocks:
    it takes ``tile=1, group=1`` (anything else raises ``ValueError``) and
    element inputs. At tile 1 every block is one element, so the block,
    compact and exact patterns coincide, and the panels are C's entries in
    CSR order. The symbolic phase expands each A entry ``(i, k)`` against
    B's row ``k`` and orders the pairs by ``(i, j)``, ``k`` ascending
    (:func:`~repro_torch.core.schedule.build_exact_schedule`, in seconds
    where the block builder would run for minutes at that tile), under the
    same spans as the block phase; the kernel sums each entry's pairs in
    K1's order, one thread per entry, so its float32 results equal the
    block path's. ``execute``, ``execute_batch`` and the pipeline serve it
    as any element plan, and it chains with exact plans only
    (:meth:`SpGEMMPlan.then`, :func:`plan_from_structural_pattern`);
    ``mesh``, ``autotune`` and persistence (``persist_artifacts``; the
    disk tier stores nothing for it) raise ``ValueError``. Exact plans
    live under their own cache keys (suffixed ``"exact"``).

    ``autotune=True`` (or a dict of
    :func:`repro_torch.spgemm.autotune.autotune_plan` keyword overrides,
    e.g. ``{"repeats": 5}``) runs the per-pattern config search — or
    loads its persisted result with zero probes — and returns the winning
    plan with its :class:`~repro_torch.spgemm.autotune.TunedConfig`
    applied. It composes with ``output="block"`` only.

    ``validate="deep"`` opts this call into full static verification
    (:func:`repro_torch.analysis.verify.verify_plan`): the returned plan —
    fresh build, cache hit, disk rehydrate or tuned plan — has every
    schedule, assembly, race-freedom (over the runs staged for the
    kernel), compact-map and shard-partition invariant checked, and a
    failure raises :class:`~repro_torch.analysis.verify.PlanVerificationError`.
    Disk rehydrates are verified *inside* the loader, so a
    corrupted-but-digest-valid artifact counts as a ``load_failure`` and
    falls back to a clean symbolic rebuild instead of executing.
    ``validate=None`` (the default) verifies nothing; any other value
    raises ``ValueError``. The accepting check's report is kept in
    ``plan.report.verify_report``, true as of that check.
    """
    _check_validate(validate)
    _check_output(output)
    if output == "exact":
        _check_exact(tile, group, mesh, mesh_axis)
        if autotune:
            raise _not_served("autotune (its search is over block tiles)")
        if isinstance(a, BCSV) or isinstance(b, BCSR):
            raise _not_served("pre-converted block inputs (pass element inputs)")
    verified: list = []  # plans a loader of this call verified
    if autotune and output != "block":
        raise ValueError(
            "autotune composes with output='block' only: tune the block "
            "plan, then request output='compact' separately (tuned knobs "
            "are output-independent)"
        )
    if autotune:
        from repro_torch.spgemm.autotune import autotune_plan

        spec = dict(autotune) if isinstance(autotune, dict) else {}
        # The tuned plan is verified afterwards (the search builds its
        # candidates through this function without `validate`).
        return _deep_verify(autotune_plan(
            a, b, tile=tile, group=group, backend=backend, device=device,
            cache=cache, mesh=mesh, mesh_axis=mesh_axis,
            pattern_token=pattern_token, **spec,
        ), validate)
    device = _plan_device(device, mesh)
    backend = resolve_backend(backend, device)
    cache = _cache_check(cache)
    shard_key = _mesh_key(mesh, mesh_axis)
    dev_key = str(device)
    out_key = (output,) if output != "block" else ()

    token_key = None
    if pattern_token is not None:
        token_key = ("token", str(pattern_token), _normalize_tile(tile), int(group), backend,
                     dev_key, shard_key) + out_key
        plan = cache.token_get(token_key)
        # The value dtype is part of the full (digest) key but not of the
        # token key: a mismatch falls through to the digest path, where
        # token_bind raises the conflict.
        if plan is not None and _dtype_mismatch(plan, a, b):
            plan = None
        if plan is None and a is not None and b is not None:
            # Warm restart: the store's alias index may resolve the token
            # straight to a disk load, with no digest.
            plan, fresh = cache.token_disk_get(
                token_key,
                _token_disk_loader(a, b, backend, device, mesh, mesh_axis, output, validate,
                                   verified))
            if fresh:
                # Verified by the loader; values were bound there.
                plan.report.pattern_token = str(pattern_token)
                return _served(plan, cache, False)
            if plan is not None and _dtype_mismatch(plan, a, b):
                plan = None
        if plan is not None:
            return _served(plan, cache, True, _token_values(plan, a, b, pattern_token),
                           validate=validate, verified=verified)
        if a is None or b is None:
            raise KeyError(
                f"pattern_token {pattern_token!r} is not resident in the plan cache and "
                f"no operands were given to build from"
            )

    def served(plan: SpGEMMPlan, hit: bool, vals, key: Tuple) -> SpGEMMPlan:
        return _served(plan, cache, hit, vals, validate=validate, verified=verified,
                       dtype_names=dtype_names,
                       token=None if token_key is None else (token_key, key, pattern_token))

    dtype_names = (_input_dtype_name(a), _input_dtype_name(b))
    if isinstance(a, BCSV) and isinstance(b, BCSR):
        if a.block_shape[1] != b.block_shape[0]:
            raise ValueError(
                f"block inner dims mismatch: {a.block_shape} vs {b.block_shape}"
            )
        tile3 = (a.block_shape[0], a.block_shape[1], b.block_shape[1])
        key = (_block_pattern_key(a, b), tile3, a.group, backend, dev_key,
               shard_key) + out_key
        plan, hit = cache.get_or_build(
            key, lambda: SpGEMMPlan.from_blocks(
                a, b, backend=backend, device=device, pattern_key=key[0],
                mesh=mesh, mesh_axis=mesh_axis, output=output),
            loader=lambda arrays, meta: _loaded_block_plan(
                arrays, meta, a, b, backend=backend, device=device, pattern_key=key[0],
                mesh=mesh, mesh_axis=mesh_axis, output=output, validate=validate,
                verified=verified),
        )
        # A hit is pattern-equal and may carry fresh values: this call's
        # blocks become the plan's, so that a no-arg execute() is current.
        return served(plan, hit, (a.blocks, b.blocks), key)

    bm, bk, bn = _normalize_tile(tile)
    with span("spgemm.plan.inputs") as inputs:
        a_coo, b_coo, sorts = _canonical_operands(a, b)
        inputs.count(sorts=sorts)
        if a_coo.shape[1] != b_coo.shape[0]:
            raise ValueError(f"inner dims mismatch: {a_coo.shape} x {b_coo.shape}")
        # The value dtypes, from the inputs themselves: to_coo widens a
        # bfloat16 tensor's values to float32 (exactly).
        dtypes = tuple(_packed_dtype(x if isinstance(x, torch.Tensor) else coo.val)
                       for x, coo in ((a, a_coo), (b, b_coo)))
        # The value dtype is part of the key: a float64 request is not
        # served (and rounded) by a float32-built plan.
        pattern = pattern_digest(
            a_coo.row, a_coo.col, b_coo.row, b_coo.col,
            meta=("coo", a_coo.shape, b_coo.shape) + tuple(
                "bfloat16" if dt == torch.bfloat16 else str(coo.val.dtype)
                for dt, coo in zip(dtypes, (a_coo, b_coo))),
        )
    key = (pattern, (bm, bk, bn), group, backend, dev_key, shard_key) + out_key

    def load(arrays: dict, meta: dict) -> SpGEMMPlan:
        # Disk tier (warm restart): the symbolic artifacts come from the
        # store, the values from this call's canonical COOs.
        return _deep_verify(SpGEMMPlan.from_artifacts(
            arrays, meta, backend=backend, device=device, pattern_key=pattern,
            a_vals=a_coo.val, b_vals=b_coo.val, a_pattern=a_coo, b_pattern=b_coo,
            mesh=mesh, mesh_axis=mesh_axis, output=output,
        ), validate, verified)

    def build() -> SpGEMMPlan:
        if output == "exact":
            return _exact_plan(a_coo, b_coo, dtypes, pattern, backend, device)
        return _element_plan(a_coo, b_coo, dtypes, pattern, (bm, bk, bn), group, backend,
                             device, output, mesh, mesh_axis)

    plan, hit = cache.get_or_build(key, build, loader=load)
    # A hit may carry the previous caller's values; the pattern matches by
    # construction, so this call's are bound.
    return served(plan, hit, (a_coo.val, b_coo.val), key)


def _element_plan(a_coo: COO, b_coo: COO, dtypes, pattern, tile, group, backend, device,
                  output, mesh=None, mesh_axis=None) -> SpGEMMPlan:
    """The symbolic phase of an element plan from canonical COO operands,
    whose values become the plan's."""
    bm, bk, bn = tile
    with span("spgemm.plan.convert"):
        a_bcsv, a_scatter = bcsv_from_coo(a_coo, (bm, bk), group)
        b_bcsr, b_scatter = bcsr_from_coo(b_coo, (bk, bn))
    schedule = _build_schedule(a_bcsv, b_bcsr)
    report = _make_report(
        pattern, (bm, bk, bn), group, backend,
        (a_coo.shape[0], b_coo.shape[1]),
        a_coo.nnz, b_coo.nnz, a_bcsv.nnzb, b_bcsr.nnzb, schedule,
    )
    plan_cls, extra = _resolve_plan_cls(mesh, mesh_axis)
    return plan_cls(
        schedule=schedule,
        a_vals=a_coo.val,
        b_vals=b_coo.val,
        block_shapes=(a_bcsv.blocks.shape, b_bcsr.blocks.shape),
        value_dtypes=dtypes,
        backend=backend,
        device=device,
        out_shape=(a_coo.shape[0], b_coo.shape[1]),
        report=report,
        a_scatter=a_scatter,
        b_scatter=b_scatter,
        a_pattern=a_coo,
        b_pattern=b_coo,
        output=output,
        **extra,
    )


def _exact_plan(a_coo: COO, b_coo: COO, dtypes, pattern, backend, device) -> SpGEMMPlan:
    """The symbolic phase of an ``output="exact"`` plan from canonical COO
    operands. At tile 1 the packed blocks are the values themselves, in
    canonical order ``[nnz, 1, 1]``, and the scatter is the identity
    (what :func:`bcsv_from_coo` and :func:`bcsr_from_coo` return there)."""
    with span("spgemm.plan.convert"):
        a_scatter = np.arange(a_coo.nnz, dtype=np.int64)
        b_scatter = np.arange(b_coo.nnz, dtype=np.int64)
    schedule = _build_exact_schedule(a_coo, b_coo)
    report = _make_report(
        pattern, (1, 1, 1), 1, backend, (a_coo.shape[0], b_coo.shape[1]),
        a_coo.nnz, b_coo.nnz, a_coo.nnz, b_coo.nnz, schedule,
    )
    return SpGEMMPlan(
        schedule=schedule,
        a_vals=a_coo.val,
        b_vals=b_coo.val,
        block_shapes=((a_coo.nnz, 1, 1), (b_coo.nnz, 1, 1)),
        value_dtypes=dtypes,
        backend=backend,
        device=device,
        out_shape=(a_coo.shape[0], b_coo.shape[1]),
        report=report,
        a_scatter=a_scatter,
        b_scatter=b_scatter,
        a_pattern=a_coo,
        b_pattern=b_coo,
        output="exact",
    )


# ---------------------------------------------------------------------------
# Structural plan composition (the chaining layer)
#
# C's pattern is value-independent, so one plan's output *structure* fully
# determines the next plan's A-side input structure: no values, no COO
# conversion, no canonicalizing sort. A plan's ``output_pattern()`` feeds
# ``plan_from_structural_pattern``, and ``execute_chain`` hands each
# stage's packed device values straight to the next stage's rebind.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StructuralPattern:
    """A CSR-shaped structural sparsity pattern, detached from any values.

    A plan's value-independent output structure
    (:meth:`SpGEMMPlan.output_pattern`) in the exact arrays its results
    share, and the seed :func:`plan_from_structural_pattern` builds the
    next chained plan from. Its order (row-major, strictly ascending
    ``(row, col)``) is canonical COO order, which is what lets a previous
    stage's packed values bind positionally as the next stage's A values.
    """

    indptr: np.ndarray  # [m + 1] CSR row pointers
    indices: np.ndarray  # [nnz] int32 CSR column ids
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def rows(self) -> np.ndarray:
        """The expanded per-element row ids (canonical order)."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int64), np.diff(self.indptr))

    def to_coo(self, val=None, dtype=np.float32) -> COO:
        """The pattern as canonical COO; ``val=None`` fills placeholder
        zeros (chained plans bind real values per execute)."""
        if val is None:
            val = np.zeros(self.nnz, dtype)
        return COO(self.rows(), self.indices, val, self.shape)


def _check_chain_link(p: SpGEMMPlan, q: SpGEMMPlan, stage: int) -> None:
    """Stage ``stage + 1``'s A pattern must be stage ``stage``'s output
    pattern, elementwise: the positional-binding contract of
    :func:`execute_chain`."""
    if q.kind != "element":
        raise ValueError(
            f"chain stage {stage + 1} is not an element plan; chained "
            f"stages are built by plan_from_structural_pattern"
        )
    asm = p._active()
    pat = q.a_pattern
    if pat is None or tuple(pat.shape) != (p._m, p._n):
        got = None if pat is None else tuple(pat.shape)
        raise ValueError(
            f"chain stage {stage + 1}: A shape {got} != stage {stage} "
            f"output shape {(p._m, p._n)}"
        )
    if q.device != p.device:
        raise ValueError(
            f"chain stage {stage + 1} runs on {q.device}, stage {stage} on {p.device}: "
            f"a chain keeps its intermediates on one device"
        )
    if q.report.nnz_a != asm.nnz or not (
        np.array_equal(pat.col, asm.indices)
        and np.array_equal(np.bincount(pat.row, minlength=p._m), np.diff(asm.indptr))
    ):
        raise ValueError(
            f"chain stage {stage + 1}: A pattern does not match stage "
            f"{stage}'s output pattern; build it from that plan's "
            f"output_pattern() (plan.then / plan_from_structural_pattern)"
        )


class SpGEMMChain:
    """An ordered composition of plans: ``A @ B1 @ B2 @ ...`` where stage
    ``s + 1``'s A pattern *is* stage ``s``'s output pattern (validated at
    construction). :meth:`execute` runs the whole chain with every
    intermediate on the device: the only device-to-host copy is the final
    result's."""

    def __init__(self, plans: Sequence[SpGEMMPlan]):
        plans = list(plans)
        if not plans:
            raise ValueError("a chain needs at least one plan")
        if len({p.output == "exact" for p in plans}) > 1:
            raise _mixed_chain()
        for s, (p, q) in enumerate(zip(plans, plans[1:])):
            _check_chain_link(p, q, s)
        self.plans = plans

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.plans[0]._m, self.plans[-1]._n)

    def then(self, b, **kwargs) -> "SpGEMMChain":
        """Extend the chain by one more operand (see
        :meth:`SpGEMMPlan.then`)."""
        return SpGEMMChain(self.plans + [self.plans[-1]._plan_next(b, **kwargs)])

    def output_pattern(self) -> StructuralPattern:
        return self.plans[-1].output_pattern()

    def device_indptr(self) -> torch.Tensor:
        return self.plans[-1].device_indptr()

    def execute(self, a_vals=None, b_vals=None) -> CSR:
        """Run the chain; ``a_vals``/``b_vals`` are stage 1's operands
        (same contract as :meth:`SpGEMMPlan.execute`), later stages use
        their own staged B values."""
        return execute_chain(self.plans, a_vals=a_vals, b_vals=b_vals)

    __call__ = execute


def chain_plans(plans: Sequence[SpGEMMPlan]) -> SpGEMMChain:
    """Validate and wrap an ordered plan list as a :class:`SpGEMMChain`
    (each plan's A pattern must be its predecessor's output pattern)."""
    return SpGEMMChain(plans)


def execute_chain(plans, a_vals=None, b_vals=None) -> CSR:
    """Run ``A @ B1 @ B2 @ ...`` through a validated plan chain with the
    intermediates on the device.

    Stage 1 runs exactly like ``plans[0].execute`` but keeps its packed C
    values on the device; every later stage binds the previous packed
    values as its A values (active-map order is canonical element order,
    so the binding is positional), rounded to its A dtype, against its
    own staged B values: no intermediate CSR, no host transfer. The final
    stage's values are copied to the host once and wrapped in its
    precomputed CSR structure. Bitwise-equal to executing each stage on
    its own with a host round trip between them (the same operations on
    the same operand bits).

    ``plans`` is a :class:`SpGEMMChain` or a plan sequence (validated
    here); ``a_vals``/``b_vals`` optionally rebind stage 1's operands
    (a tensor on a CUDA plan's device is bound there, with no copy
    through the host). The span ``spgemm.chain`` covers the run and
    counts its ``stages`` and ``pairs`` (the products of every stage).
    """
    if isinstance(plans, SpGEMMChain):
        plans = plans.plans
    else:
        plans = SpGEMMChain(plans).plans
    pairs = sum(p._executor.pairs for p in plans if p._executor is not None)
    with span("spgemm.chain", stages=len(plans), pairs=pairs):
        packed = plans[0]._run_packed(a_vals, b_vals)
        for s, stage in enumerate(plans[1:], 2):
            packed = stage._run_packed_chained(packed, s)
        last = plans[-1]
        if packed is None:
            return last._empty_csr()
        return last._wrap_packed(packed)


def _coo_is_canonical(coo: COO) -> bool:
    """True when the COO is strictly increasing in row-major (row, col)
    order: sorted and deduplicated."""
    r0, r1 = coo.row[:-1], coo.row[1:]
    return bool(np.all((r1 > r0) | ((r1 == r0) & (coo.col[1:] > coo.col[:-1]))))


def plan_from_structural_pattern(
    c_pattern: StructuralPattern,
    b,
    *,
    tile: Union[int, Tuple[int, ...]] = 64,
    group: int = 4,
    backend: str = "auto",
    device="cuda",
    output: str = "block",
    dtype=torch.float32,
    cache: Optional[PlanCache] = None,
    mesh: Optional[Mesh] = None,
    mesh_axis: Optional[str] = None,
    validate=None,
) -> SpGEMMPlan:
    """Plan ``C @ b`` directly from a prior plan's output pattern: the
    chaining fast path.

    Where :func:`spgemm_plan` would convert C to COO and sort it, this
    builds the A-side COO *positionally* from the CSR pattern (canonical
    by construction) and fingerprints the CSR arrays themselves. A values
    are zero placeholders (chained executes bind the previous stage's
    device values per run); ``dtype`` is the value dtype they flow at
    (bfloat16, or float32 for any other; part of the cache key). ``b`` is
    anything :func:`spgemm_plan` takes as an element operand; its values
    set the plan's B dtype.

    ``output="exact"`` (at ``tile=1, group=1``) builds the element plan of
    :func:`spgemm_plan`'s exact output, with the identity binds and
    assembly: the previous stage's exact values are its A values as they
    lie. It chains only with exact plans.

    Chained plans get their own cache keys (a ``"chain"``-tagged digest,
    suffixed with the output when it is not block) and the same two-tier
    :class:`~repro_torch.spgemm.cache.PlanCache` as any other plan
    (``cache``, default the process-level one): a warm restart rehydrates
    a whole chain from disk without re-running any symbolic phase (exact
    stages excepted: the disk tier stores none). ``mesh``/``mesh_axis`` give a
    :class:`ShardedSpGEMMPlan`, as in :func:`spgemm_plan`.
    ``validate="deep"`` verifies the returned plan statically, and a disk
    rehydrate inside its loader, as :func:`spgemm_plan` does.
    """
    _check_validate(validate)
    _check_output(output)
    if output == "exact":
        _check_exact(tile, group, mesh, mesh_axis)
    verified: list = []  # the plan the loader verified, if it loaded one
    device = _plan_device(device, mesh)
    backend = resolve_backend(backend, device)
    cache = _cache_check(cache)
    shard_key = _mesh_key(mesh, mesh_axis)
    bm, bk, bn = _normalize_tile(tile)
    b_coo, _ = _canonical_coo(to_coo(b))
    if c_pattern.shape[1] != b_coo.shape[0]:
        raise ValueError(f"inner dims mismatch: {c_pattern.shape} x {b_coo.shape}")
    dtypes = (_value_dtype(dtype),
              _packed_dtype(b if isinstance(b, torch.Tensor) else b_coo.val))
    a_coo = c_pattern.to_coo()
    pattern = pattern_digest(
        c_pattern.indptr, c_pattern.indices, b_coo.row, b_coo.col,
        meta=("chain", c_pattern.shape, b_coo.shape) + tuple(_dtype_name(d) for d in dtypes),
    )
    out_key = (output,) if output != "block" else ()
    key = (pattern, (bm, bk, bn), group, backend, str(device), shard_key) + out_key
    with cache._lock:
        cache.stats.chain_lookups += 1

    def load(arrays: dict, meta: dict) -> SpGEMMPlan:
        return _deep_verify(SpGEMMPlan.from_artifacts(
            arrays, meta, backend=backend, device=device, pattern_key=pattern,
            a_vals=a_coo.val, b_vals=b_coo.val, a_pattern=a_coo, b_pattern=b_coo,
            mesh=mesh, mesh_axis=mesh_axis, output=output,
        ), validate, verified)

    def build() -> SpGEMMPlan:
        if output == "exact":
            return _exact_plan(a_coo, b_coo, dtypes, pattern, backend, device)
        return _element_plan(a_coo, b_coo, dtypes, pattern, (bm, bk, bn), group, backend,
                             device, output, mesh, mesh_axis)

    plan, hit = cache.get_or_build(key, build, loader=load)
    if hit:
        # A pattern-equal hit may serve another B operand: it becomes the
        # chained stage's B (restaged by the next chained execute) and the
        # plan's bound B. The A placeholders stay: chained executes bind A
        # per run, on the device.
        with plan._lock:
            plan.b_pattern = b_coo
            plan._b_vals_dev = None
    return _served(plan, cache, hit, (None, b_coo.val), validate=validate, verified=verified)
