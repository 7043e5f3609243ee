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
* :meth:`SpGEMMPlan.execute` keeps the lock / host-value staging
  semantics (no-arg ``execute()`` reuses staged values) and wraps the
  packed C values in the precomputed CSR structure;
  :meth:`SpGEMMPlan.execute_batch` runs a leading batch of value sets.

Plans run on the card: ``device="cuda"`` is the default and raises when no
CUDA device is present; ``device="cpu"`` runs the plain PyTorch version.

Value dtype: a plan keeps the packed dtype of the values it was built on,
as the JAX package does: bfloat16 (a numpy array whose dtype is named
``bfloat16``, or a bfloat16 tensor) or float32 (every other float type;
float64 is cast, as the JAX package does with 64-bit mode off). Every
later rebind, single or batched, host or device, rounds its values to that
dtype (round to nearest even, as ``astype`` does), and a bfloat16 plan
stages bfloat16 blocks, so the kernel reads them as bfloat16; C is float32
either way. The port imports no ``ml_dtypes``: a numpy bfloat16 array is
read through a 16-bit view, and the plan holds its packed blocks on the
host as CPU tensors of its dtype.

Output convention: C's CSR pattern is *structural* (every element of every
structurally nonzero C block, trimmed to the true shape), so values that
compute to exact zero are stored explicitly — the pattern is
value-independent, which is what makes assembly a static gather.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.schedule import (
    AssemblyMap,
    SpGEMMSchedule,
    assembly_from_arrays,
    build_assembly_map,
    build_spgemm_schedule,
    schedule_from_arrays,
)
from repro_torch.kernels.backend import resolve_backend, resolve_device
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo, to_coo
from repro_torch.sparse.formats import BCSR, BCSV, COO, CSR
from repro_torch.spgemm.cache import pattern_digest
from repro_torch.spgemm.executor import CHUNK_BYTES_ENV, SpGEMMExecutor

__all__ = [
    "PlanReport",
    "SpGEMMPlan",
    "resolve_backend",
    "resolve_device",
    "spgemm_plan",
]

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
    ``count_nonzero`` scans. The cache, disk-tier and tuning fields keep
    their names and defaults; nothing in the port sets them yet.
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
        config_source: str = "default",  # "default" (policy) or
        # "env-override" (REPRO_SPGEMM_CHUNK_BYTES wins regardless)
        tuned: Optional[dict] = None,
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


class SpGEMMPlan:
    """A fully pre-processed SpGEMM: symbolic phase done, numeric phase
    repeatable — single-shot or batched — with fresh values.

    Build through :func:`spgemm_plan` or :meth:`SpGEMMPlan.from_blocks`.
    ``execute`` / ``__call__`` accept new value sets bound to the *same*
    sparsity pattern:

    * element plans (built from COO/CSR/dense inputs): ``a_vals`` is a
      ``[nnz_a]`` vector aligned with ``plan.a_pattern`` (canonical
      row-major deduplicated order), likewise ``b_vals``;
    * block plans (built from BCSV/BCSR inputs): ``a_vals`` is a packed
      ``[nnzb_a, bm, bk]`` block array, likewise ``b_vals``.

    Values may be numpy arrays or tensors. Passing ``None`` reuses the
    values staged at build / last execute. ``execute_batch`` takes the same
    per-set shapes with a leading batch axis.

    Results returned by one plan share the precomputed CSR ``indptr`` /
    ``indices`` arrays (treat them as read-only).
    """

    def __init__(
        self,
        *,
        schedule: SpGEMMSchedule,
        a_blocks,
        b_blocks,
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
    ):
        self.schedule = schedule
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.report = report
        self.a_pattern = a_pattern
        self.b_pattern = b_pattern
        self._a_scatter = a_scatter
        self._b_scatter = b_scatter
        # The packed dtypes of the values the plan was built on, and the
        # host packed blocks (CPU tensors of those dtypes).
        self._a_dtype, self._b_dtype = value_dtypes
        self._a_blocks = _host_values(a_blocks, self._a_dtype)
        self._b_blocks = _host_values(b_blocks, self._b_dtype)
        self._a_shape = tuple(self._a_blocks.shape)
        self._b_shape = tuple(self._b_blocks.shape)
        self._m, self._n = out_shape
        self._group = schedule.group
        self._bm = int(self._a_shape[1]) if len(self._a_shape) == 3 else 0
        self._bn = int(self._b_shape[2]) if len(self._b_shape) == 3 else 0
        # Symbolic output structure: C's CSR pattern + the panels->CSR
        # gather map, consumed on device by the executor.
        self.assembly: AssemblyMap = (
            assembly if assembly is not None
            else build_assembly_map(schedule, (self._bm, self._bn), out_shape)
        )
        self._executor = (
            SpGEMMExecutor(
                schedule=schedule,
                assembly=self.assembly,
                backend=self.backend,
                device=self.device,
                a_scatter=a_scatter,
                b_scatter=b_scatter,
                a_shape=self._a_shape,
                b_shape=self._b_shape,
            )
            if schedule.num_triples and self.assembly.nnz
            else None
        )
        # Device block values are staged lazily (first no-arg execute).
        self._a_dev = None
        self._b_dev = None
        # Guards value rebinds + report counters, so concurrent executes
        # each see a consistent (values, device array) pair.
        self._lock = threading.Lock()

    def _stage(self, blocks: torch.Tensor) -> torch.Tensor:
        """Host packed blocks -> a device copy (never an alias of the host
        scratch that later rebinds write into)."""
        return blocks.to(self.device, copy=True)

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
    ) -> "SpGEMMPlan":
        """Plan from pre-converted block formats (the ops.spgemm shim path).

        When ``schedule`` is supplied the symbolic phase is skipped
        (``report.schedule_builds == 0``). The pattern digest and element
        nnz counts in the report are computed only if read.
        """
        device = resolve_device(device)
        backend = resolve_backend(backend, device)
        built = 0
        if schedule is None:
            schedule = build_spgemm_schedule(a, b)
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
        plan = cls(
            schedule=schedule,
            a_blocks=a.blocks,
            b_blocks=b.blocks,
            value_dtypes=(_packed_dtype(a.blocks), _packed_dtype(b.blocks)),
            backend=backend,
            device=device,
            out_shape=(a.shape[0], b.shape[1]),
            report=report,
        )
        report._nnz_a = _staged_nnz(plan, "_a_blocks")
        report._nnz_b = _staged_nnz(plan, "_b_blocks")
        return plan

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
    ) -> "SpGEMMPlan":
        """Build a plan from persisted symbolic artifacts + this call's values.

        ``(arrays, meta)`` is what the JAX package's
        ``SpGEMMPlan.persist_artifacts()`` returns for a single-device plan
        with block output: the triple schedule, the assembly map and, for
        element plans, the value-scatter indices. The symbolic phase is
        **not** re-run (``report.schedule_builds == 0``). The packed block
        arrays are rebuilt by scattering ``a_vals``/``b_vals`` through the
        persisted scatter indices (element plans) or taken from
        ``a_blocks``/``b_blocks`` (block plans). The persisted backend
        names the other package's backend and is not read. Any
        inconsistency between artifacts and inputs raises.
        """
        device = resolve_device(device)
        backend = resolve_backend(backend, device)
        kind = meta.get("kind")
        if kind not in ("element", "block"):
            raise ValueError(f"unknown persisted plan kind {kind!r}")
        if meta.get("output", "block") != "block":
            raise ValueError(
                f"persisted output {meta.get('output')!r}: only block "
                f"output is ported"
            )
        if "shard_bounds" in arrays:
            raise ValueError("sharded plan artifacts are not ported")
        schedule = schedule_from_arrays(arrays)
        assembly = assembly_from_arrays(arrays)
        a_shape = tuple(int(x) for x in meta["a_shape"])
        b_shape = tuple(int(x) for x in meta["b_shape"])
        out_shape = tuple(int(x) for x in meta["out_shape"])
        tile = tuple(int(x) for x in meta["tile"])
        group = int(meta["group"])
        a_scatter = arrays.get("a_scatter")
        b_scatter = arrays.get("b_scatter")
        # The persisted value dtypes (the JAX package's names).
        a_dtype, b_dtype = (
            torch.bfloat16 if str(meta.get(f"{x}_dtype", "float32")) == "bfloat16"
            else torch.float32
            for x in ("a", "b")
        )

        def rebuild(vals, scatter, shape, dtype, name):
            if scatter is None:
                raise ValueError(f"{name}: persisted scatter missing")
            vals = _host_values(vals, dtype)
            scatter = np.asarray(scatter)
            if vals.shape != (int(scatter.shape[0]),):
                raise ValueError(
                    f"{name}: {tuple(vals.shape)} values vs persisted scatter "
                    f"of {int(scatter.shape[0])}"
                )
            blocks = torch.zeros(shape, dtype=dtype)
            blocks.view(-1)[torch.from_numpy(np.asarray(scatter, np.int64))] = vals
            return blocks

        if kind == "element":
            if a_vals is None or b_vals is None:
                raise ValueError("element plan needs a_vals/b_vals")
            a_blocks = rebuild(a_vals, a_scatter, a_shape, a_dtype, "a_vals")
            b_blocks = rebuild(b_vals, b_scatter, b_shape, b_dtype, "b_vals")
            nnz_a = int(np.asarray(a_scatter).shape[0])
            nnz_b = int(np.asarray(b_scatter).shape[0])
        else:
            if a_blocks is None or b_blocks is None:
                raise ValueError("block plan needs a_blocks/b_blocks")
            a_blocks = _as_tensor(a_blocks, a_dtype)
            b_blocks = _as_tensor(b_blocks, b_dtype)
            if tuple(a_blocks.shape) != a_shape:
                raise ValueError(f"a_blocks {a_blocks.shape} vs persisted {a_shape}")
            if tuple(b_blocks.shape) != b_shape:
                raise ValueError(f"b_blocks {b_blocks.shape} vs persisted {b_shape}")
            nnz_a = nnz_b = 0  # bound to staged blocks below (lazy)
        report = _make_report(
            pattern_key, tile, group, backend, out_shape, nnz_a, nnz_b,
            a_shape[0] if len(a_shape) == 3 else 0,
            b_shape[0] if len(b_shape) == 3 else 0, schedule,
        )
        report.schedule_builds = 0
        report.loads = 1
        plan = cls(
            schedule=schedule,
            a_blocks=a_blocks,
            b_blocks=b_blocks,
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
        )
        if kind == "block":
            report._nnz_a = _staged_nnz(plan, "_a_blocks")
            report._nnz_b = _staged_nnz(plan, "_b_blocks")
        return plan

    # -- numeric phase ----------------------------------------------------

    def _rebind(
        self,
        vals,
        blocks: torch.Tensor,
        scatter: Optional[np.ndarray],
        nnz: int,
        name: str,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
    ) -> torch.Tensor:
        """``vals`` rounded to the packed ``dtype`` and, for element plans,
        scattered into ``blocks``; returns the host packed blocks."""
        vals = _host_values(vals, dtype)
        if scatter is not None:
            if vals.shape != (nnz,):
                raise ValueError(
                    f"{name}: expected [{nnz}] values in canonical pattern "
                    f"order, got shape {tuple(vals.shape)}"
                )
            # Positions outside `scatter` are structurally zero and never
            # written, so in-place rebinding is sound.
            blocks.view(-1)[torch.from_numpy(np.asarray(scatter, np.int64))] = vals
            return blocks
        if vals.shape != shape:
            raise ValueError(
                f"{name}: expected packed blocks of shape {shape}, "
                f"got {tuple(vals.shape)}"
            )
        return vals

    def value_shapes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-set operand shapes the numeric phase accepts:
        ``(want_a, want_b)`` — ``[nnz]`` vectors for element plans, packed
        block arrays for block plans. ``execute_batch`` takes the same
        shapes with a shared leading batch axis."""
        if self._a_scatter is not None and self._b_scatter is not None:
            return (self.report.nnz_a,), (self.report.nnz_b,)
        return self._a_shape, self._b_shape

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
        """Packed C values (assembly-map order) -> CSR on the precomputed
        structure. indptr/indices are shared across this plan's results."""
        asm = self.assembly
        return CSR(asm.indptr, asm.indices, packed.cpu().numpy(), (self._m, self._n))

    def device_indptr(self) -> torch.Tensor:
        """Device-resident CSR ``indptr`` (int32) of C. Together with a
        ``_run_packed`` result this is a complete CSR replica of C that
        never leaves the device."""
        if self._executor is None:
            return torch.from_numpy(self.assembly.indptr.astype(np.int32)).to(self.device)
        return self._executor.device_indptr()

    def execute(self, a_vals=None, b_vals=None) -> CSR:
        """Numeric phase only: C = A @ B for fresh values on the planned
        pattern. Zero schedule-construction work."""
        packed = self._run_packed(a_vals, b_vals)
        if packed is None:
            return self._empty_csr()
        return self._wrap_packed(packed)

    __call__ = execute

    def _run_packed(self, a_vals=None, b_vals=None) -> Optional[torch.Tensor]:
        """``execute``'s device core: run the numeric phase and return the
        packed C values on the device (``None`` for an empty plan)."""
        with self._lock:
            if a_vals is not None:
                self._a_blocks = self._rebind(
                    a_vals, self._a_blocks, self._a_scatter,
                    self.report.nnz_a if self._a_scatter is not None else 0,
                    "a_vals", self._a_shape, self._a_dtype,
                )
                self._a_dev = None
            if b_vals is not None:
                self._b_blocks = self._rebind(
                    b_vals, self._b_blocks, self._b_scatter,
                    self.report.nnz_b if self._b_scatter is not None else 0,
                    "b_vals", self._b_shape, self._b_dtype,
                )
                self._b_dev = None
            # Element plans called with both value vectors take the fused
            # device path (rebind + kernel + assembly on the device): only
            # [nnz] vectors cross to the device, not full packed blocks.
            # The host rebind above still ran, so no-arg execute() stays
            # current.
            fused_values = (
                a_vals is not None and b_vals is not None
                and self._a_scatter is not None
                and self._b_scatter is not None
            )
            if not fused_values:
                if self._a_dev is None:
                    self._a_dev = self._stage(self._a_blocks)
                if self._b_dev is None:
                    self._b_dev = self._stage(self._b_blocks)
                # Snapshot under the lock so a concurrent rebind cannot mix
                # one caller's A with another's B.
                a_dev, b_dev = self._a_dev, self._b_dev
            self.report.executes += 1

        if self._executor is None:
            return None
        if fused_values:
            return self._executor.run_values(
                _device_values(a_vals, self.device, self._a_dtype),
                _device_values(b_vals, self.device, self._b_dtype),
            )
        return self._executor.run(a_dev, b_dev)

    def execute_batch(self, a_vals, b_vals) -> list:
        """Batched numeric phase over a leading value-batch axis.

        ``a_vals`` is ``[batch, nnz_a]`` for element plans or
        ``[batch, nnzb_a, bm, bk]`` packed blocks for block plans
        (``b_vals`` likewise). Returns a list of ``batch`` CSR results that
        share this plan's precomputed ``indptr``/``indices``, each
        bitwise-equal to ``execute`` on the same values.

        Stateless with respect to the plan's staged values: it never
        touches the buffers no-arg ``execute()`` reuses. Values are rounded
        to the plan's packed dtypes, as ``execute`` rounds them.
        """
        if not isinstance(a_vals, torch.Tensor):
            a_vals = np.asarray(a_vals)
        if not isinstance(b_vals, torch.Tensor):
            b_vals = np.asarray(b_vals)
        rebind = self._a_scatter is not None and self._b_scatter is not None
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
            self.report.executes += batch
        if batch == 0:
            return []
        if self._executor is None:
            return [self._empty_csr() for _ in range(batch)]
        # Oversized batches are split (SpGEMMExecutor.batch_chunk); each
        # chunk is still one fused device call.
        chunk = min(batch, self._executor.batch_chunk())
        out = []
        for lo in range(0, batch, chunk):
            hi = min(lo + chunk, batch)
            packed = self._executor.run_batch(
                _device_values(a_vals[lo:hi], self.device, self._a_dtype),
                _device_values(b_vals[lo:hi], self.device, self._b_dtype),
                rebind=rebind,
            ).cpu()
            out.extend(self._wrap_packed(packed[i]) for i in range(hi - lo))
        return out


def _staged_nnz(plan: SpGEMMPlan, attr: str):
    """Lazy element-count resolver reading the plan's staged blocks."""
    def resolve() -> int:
        return int(torch.count_nonzero(getattr(plan, attr)))

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


def spgemm_plan(
    a,
    b,
    *,
    tile: Union[int, Tuple[int, ...]] = 64,
    group: int = 4,
    backend: str = "auto",
    device="cuda",
) -> SpGEMMPlan:
    """Build an :class:`SpGEMMPlan` for ``C = a @ b``.

    ``a``/``b`` may be dense numpy arrays, any element-level sparse format
    (COO/CSR/CSC/CSV), pre-converted BCSV/BCSR blocks (in which case
    ``tile``/``group`` are taken from the formats themselves), or torch
    tensors (dense, sparse COO or sparse CSR). The plan keeps the packed
    dtype of the values: bfloat16 for bfloat16 values (a numpy array of
    dtype ``bfloat16`` or a bfloat16 tensor), float32 for any other. All
    symbolic work happens here. There is no plan cache yet: every call
    builds.

    ``device="cuda"`` (the default) runs the numeric phase through the
    CUDA kernel and raises when no CUDA device is present;
    ``device="cpu"`` runs the plain PyTorch version.
    """
    device = resolve_device(device)
    backend = resolve_backend(backend, device)
    if isinstance(a, BCSV) and isinstance(b, BCSR):
        if a.block_shape[1] != b.block_shape[0]:
            raise ValueError(
                f"block inner dims mismatch: {a.block_shape} vs {b.block_shape}"
            )
        return SpGEMMPlan.from_blocks(
            a, b, backend=backend, device=device,
            pattern_key=_block_pattern_key(a, b),
        )

    bm, bk, bn = _normalize_tile(tile)
    # sum_duplicates already emits canonical row-major order.
    a_coo = to_coo(a).sum_duplicates()
    b_coo = to_coo(b).sum_duplicates()
    if a_coo.shape[1] != b_coo.shape[0]:
        raise ValueError(f"inner dims mismatch: {a_coo.shape} x {b_coo.shape}")
    # The value dtypes, from the inputs themselves: to_coo widens a
    # bfloat16 tensor's values to float32 (exactly).
    dtypes = tuple(_packed_dtype(x if isinstance(x, torch.Tensor) else coo.val)
                   for x, coo in ((a, a_coo), (b, b_coo)))
    pattern = pattern_digest(
        a_coo.row, a_coo.col, b_coo.row, b_coo.col,
        meta=("coo", a_coo.shape, b_coo.shape) + tuple(
            "bfloat16" if dt == torch.bfloat16 else str(coo.val.dtype)
            for dt, coo in zip(dtypes, (a_coo, b_coo))),
    )
    a_bcsv, a_scatter = bcsv_from_coo(a_coo, (bm, bk), group)
    b_bcsr, b_scatter = bcsr_from_coo(b_coo, (bk, bn))
    schedule = build_spgemm_schedule(a_bcsv, b_bcsr)
    report = _make_report(
        pattern, (bm, bk, bn), group, backend,
        (a_coo.shape[0], b_coo.shape[1]),
        a_coo.nnz, b_coo.nnz, a_bcsv.nnzb, b_bcsr.nnzb, schedule,
    )
    return SpGEMMPlan(
        schedule=schedule,
        a_blocks=a_bcsv.blocks,
        b_blocks=b_bcsr.blocks,
        value_dtypes=dtypes,
        backend=backend,
        device=device,
        out_shape=(a_coo.shape[0], b_coo.shape[1]),
        report=report,
        a_scatter=a_scatter,
        b_scatter=b_scatter,
        a_pattern=a_coo,
        b_pattern=b_coo,
    )
