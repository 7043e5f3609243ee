"""Device-resident SpGEMM numeric executor.

FSpGEMM's throughput claim (PAPER Sec. 4) rests on the numeric phase being a
pure streaming pipeline once host pre-processing is done. This module is
that pipeline as plain functions on tensors,

    (packed A blocks, packed B blocks) -> packed C values

chaining three device-side stages:

1. **value rebind** (element plans): gather fresh ``[nnz]`` value vectors
   into the packed block arrays through the inverse of the plan's scatter
   indices, in the plan's packed dtype (float32 or bfloat16);
2. **the scheduled kernel**: the hand-written CUDA block-Gustavson kernel
   (:func:`repro_torch.kernels.gustavson_spgemm.spgemm_scheduled`) or its
   plain PyTorch version (:func:`repro_torch.kernels.ref.spgemm_scheduled_ref`);
3. **output assembly**: one static gather through the symbolic phase's
   :class:`~repro_torch.core.schedule.AssemblyMap` — no data-dependent
   ``nonzero``, no per-panel host loop.

Every stage is shape-static, so the same core runs a batch of value sets
over a leading axis (:func:`numeric_core_batch`, the engine behind
``SpGEMMPlan.execute_batch``): on the ``cuda`` backend the batch is a grid
dimension of one kernel launch
(:func:`~repro_torch.kernels.gustavson_spgemm.spgemm_scheduled_batch`), on
``torch`` a schedule with each element's indices offset. Both keep each
element's accumulation order, so a batch equals a loop of single executes
bit for bit. :class:`SpGEMMExecutor` holds a plan's device-resident
constants (schedule runs, scatter inverses, gather map — copied to the
device once).

**Stage-split pipeline surface.** Each stage is also a function of its
own (``bind_core`` / ``kernel_core`` / ``assemble_core`` and their batched
forms), and the fused cores are compositions of them, so a step run stage
by stage is the same sequence of operations. :class:`SpGEMMExecutor`
carries the pipeline protocol over them::

    staged = ex.pipe_stage(a, b, mode=...)   # host-to-device copy + rebind
    panels = ex.pipe_kernel(staged, mode)    # the scheduled kernel
    packed = ex.pipe_assemble(panels, mode)  # the assembly gather
    pend   = ex.pipe_download(packed)        # device-to-host copy, started
    out    = ex.pipe_collect(pend, mode)     # the ONLY blocking call

On a CUDA executor every step but ``pipe_collect`` only enqueues work on
the current stream: host operands come from pinned memory and go to the
card with ``non_blocking`` copies, and ``pipe_download`` copies C's
values into a fresh pinned host tensor and records an event, which
``pipe_collect`` waits on. A caller that runs each step on a stream of
its own (:class:`repro_torch.spgemm.pipeline.SpGEMMPipeline`) overlaps
step ``s + 1``'s copies and kernel with step ``s``'s: the paper's double
buffer. On the CPU every step runs at once and ``pipe_collect`` returns
its values.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import AssemblyMap, SpGEMMSchedule
from repro_torch.kernels import ref
from repro_torch.kernels.gustavson_spgemm import (
    ScheduleRuns,
    compact_csr_indptr,
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)

__all__ = [
    "CHUNK_BYTES_ENV",
    "SpGEMMExecutor",
    "assemble_batch_core",
    "assemble_core",
    "bind_batch_core",
    "bind_core",
    "kernel_batch_core",
    "kernel_core",
    "numeric_core",
    "numeric_core_batch",
    "numeric_core_values",
    "resolve_chunk_bytes",
]

# Per-device working-set budget for fusing batch elements into one device
# call: (per_set_budget_bytes, target_cache_bytes).
#
# * cpu — measured on a CPU container with the JAX package's calibration
#   probe (its repro.core.tuning.measure_chunk_knee): fused batches won up
#   to ~0.58 MiB per set and regressed from ~1.1 MiB per set, so the budget
#   splits that bracket at 0.75 MiB, with an 8 MiB chunk cap.
# * cuda — not in the table: derived from the card's own L2 size
#   (torch.cuda.get_device_properties), budget L2/8 and chunk cap the full
#   L2, by the same rule the JAX package applied to an A100's 40 MiB L2.
#   Not measured on the card yet.
#
# The env knob overrides any row without a code change.
CHUNK_BYTES_ENV = "REPRO_SPGEMM_CHUNK_BYTES"
_CHUNK_POLICY = {
    "cpu": ((3 << 20) // 4, 8 << 20),
}


def _default_chunk_policy(device: torch.device) -> Tuple[int, int]:
    if device.type == "cuda":
        l2 = int(torch.cuda.get_device_properties(device).L2_cache_size)
        return l2 // 8, l2
    return _CHUNK_POLICY["cpu"]


def resolve_chunk_bytes(
    chunk_bytes: Optional[int] = None, device="cpu"
) -> Tuple[int, int]:
    """Resolve the batch-fusion working-set budget for ``device``.

    Precedence: ``REPRO_SPGEMM_CHUNK_BYTES`` env var > explicit
    ``chunk_bytes`` > the per-device default. Returns
    ``(per_set_budget, cache_bytes)``; the cache target scales with an
    overridden budget so chunk sizing keeps its shape.
    """
    default_set, default_cache = _default_chunk_policy(torch.device(device))
    env = os.environ.get(CHUNK_BYTES_ENV)
    if env is not None:
        per_set = int(env)
    elif chunk_bytes is not None:
        per_set = int(chunk_bytes)
    else:
        return default_set, default_cache
    if per_set < 1:
        raise ValueError(f"chunk bytes must be >= 1, got {per_set}")
    scale = per_set / max(default_set, 1)
    return per_set, max(per_set, int(default_cache * scale))


def _same_dtype(a_blocks, b_blocks):
    """The kernel reads A and B in one dtype: a plan whose A and B were
    built on different dtypes (one bfloat16, one float32) runs in float32,
    which widens the bfloat16 side exactly."""
    if a_blocks.dtype != b_blocks.dtype:
        return a_blocks.float(), b_blocks.float()
    return a_blocks, b_blocks


def _run_schedule(a_blocks, b_blocks, runs: ScheduleRuns, *, backend):
    """Dispatch the scheduled kernel: panels ``[n_panels, group*bm, bn]``."""
    a_blocks, b_blocks = _same_dtype(a_blocks, b_blocks)
    if backend == "cuda":
        return spgemm_scheduled(a_blocks, b_blocks, runs)
    return ref.spgemm_scheduled_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel,
        runs.sub_row, runs.n_panels, runs.group,
    )


def _run_schedule_batch(a_blocks, b_blocks, runs: ScheduleRuns, bsz, *, backend):
    """Dispatch the batched kernel over stacked blocks (``[bsz * slots,
    ...]``): panels ``[bsz, n_panels, group*bm, bn]``."""
    a_blocks, b_blocks = _same_dtype(a_blocks, b_blocks)
    if backend == "cuda":
        return spgemm_scheduled_batch(a_blocks, b_blocks, runs, bsz=bsz)
    return ref.spgemm_scheduled_batch_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel,
        runs.sub_row, runs.n_panels, runs.group, bsz,
    )


def _invert_scatter(scatter: np.ndarray, size: int) -> np.ndarray:
    """Turn flat scatter indices (``blocks.flat[scatter] = vals``) into a
    gather map (``blocks.flat = vals_padded[inv]``), with index ``nnz``
    pointing at a zero pad slot. A gather needs no atomics and the inverse
    is value-independent — computed once at executor build."""
    inv = np.full(size, scatter.shape[0], np.int32)
    inv[scatter] = np.arange(scatter.shape[0], dtype=np.int32)
    return inv


# -- stage cores ---------------------------------------------------------------
#
# The fused cores below are compositions of these, so a step run stage by
# stage (the pipeline) runs exactly the operations of a fused call.


def bind_core(vals, inv, *, shape):
    """Stage 1 (element plans): [nnz] values -> packed blocks, as one
    gather through the precomputed scatter inverse. Positions outside the
    pattern read the zero pad."""
    pad = torch.cat([vals, vals.new_zeros(1)])
    return pad.index_select(0, inv).reshape(shape)


def bind_batch_core(vals, inv, *, shape):
    """Stage 1, batched: [batch, nnz] values -> stacked packed blocks, one
    gather per batch row through the shared scatter inverse."""
    bsz = vals.shape[0]
    pad = torch.cat([vals, vals.new_zeros((bsz, 1))], dim=1)
    return pad.index_select(1, inv).reshape((bsz * shape[0],) + tuple(shape[1:]))


def kernel_core(a_blocks, b_blocks, runs, *, backend):
    """Stage 2: packed blocks -> output panels (the scheduled kernel)."""
    return _run_schedule(a_blocks, b_blocks, runs, backend=backend)


def kernel_batch_core(a_blocks, b_blocks, runs, *, a_slots, backend):
    """Stage 2, batched: the scheduled kernel over stacked blocks
    (``[batch * slots, ...]``, as stage 1 makes them): panels
    ``[batch, n_panels, group*bm, bn]``."""
    bsz = a_blocks.shape[0] // a_slots
    return _run_schedule_batch(a_blocks, b_blocks, runs, bsz, backend=backend)


def assemble_core(panels, gather):
    """Stage 3: output panels -> packed C values (one static gather)."""
    return panels.reshape(-1).index_select(0, gather)


def assemble_batch_core(panels, gather):
    """Stage 3, batched: one gather per batch element through the shared
    map: ``[batch, nnz_c]``."""
    return panels.reshape(panels.shape[0], -1).index_select(1, gather)


def numeric_core(a_blocks, b_blocks, runs, gather, *, backend):
    """Functional numeric phase: packed blocks -> packed C values."""
    return assemble_core(kernel_core(a_blocks, b_blocks, runs, backend=backend), gather)


def numeric_core_values(
    a_vals, b_vals, a_inv, b_inv, runs, gather, *, a_shape, b_shape, backend,
):
    """Numeric phase from [nnz] value vectors: rebind + kernel + assembly."""
    return numeric_core(
        bind_core(a_vals, a_inv, shape=a_shape), bind_core(b_vals, b_inv, shape=b_shape),
        runs, gather, backend=backend,
    )


def _stack_blocks(vals, shape):
    """Batched packed blocks ``[batch, slots, ...]`` -> ``[batch * slots,
    ...]``."""
    return vals.reshape((-1,) + tuple(shape[1:]))


def numeric_core_batch(
    a_vals, b_vals, a_inv, b_inv, runs, gather, *,
    a_shape, b_shape, rebind, backend,
):
    """Batched numeric phase over a leading value axis.

    ``rebind=True`` takes [batch, nnz] value vectors (element plans);
    ``rebind=False`` takes batched packed block arrays (block plans).
    Returns packed C values ``[batch, nnz_c]``, each row bitwise-equal to
    the single-set core on the same backend.
    """
    if rebind:
        a_blocks = bind_batch_core(a_vals, a_inv, shape=a_shape)
        b_blocks = bind_batch_core(b_vals, b_inv, shape=b_shape)
    else:
        a_blocks, b_blocks = _stack_blocks(a_vals, a_shape), _stack_blocks(b_vals, b_shape)
    panels = kernel_batch_core(a_blocks, b_blocks, runs, a_slots=a_shape[0], backend=backend)
    return assemble_batch_core(panels, gather)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh page-locked copy of the CPU tensor ``t`` (from PyTorch's
    caching host allocator, which reuses a block only after the copies
    recorded on it have completed)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


class _Download:
    """A device-to-host copy in flight: the pinned host tensor it writes
    and the event recorded after it on the copying stream."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


class SpGEMMExecutor:
    """A plan's numeric phase with device-resident constants.

    Copies the schedule runs, the scatter inverses and the assembly gather
    map to ``device`` once; ``run``/``run_values``/``run_batch`` then call
    the numeric cores with no per-call host work beyond operand transfer.
    ``backend="cuda"`` runs the hand-written kernel on every path,
    ``backend="torch"`` its plain version.
    """

    def __init__(
        self,
        *,
        schedule: SpGEMMSchedule,
        assembly: AssemblyMap,
        backend: str,
        device,
        a_scatter: Optional[np.ndarray] = None,
        b_scatter: Optional[np.ndarray] = None,
        a_shape: Tuple[int, ...] = (),
        b_shape: Tuple[int, ...] = (),
        chunk_bytes: Optional[int] = None,
    ):
        self.backend = backend
        self.device = torch.device(device)
        self._chunk_policy = resolve_chunk_bytes(chunk_bytes, self.device)
        self.n_panels = schedule.n_panels
        self.group = schedule.group
        self.a_shape = tuple(a_shape)
        self.b_shape = tuple(b_shape)
        # Per-set f32 rows the batched schedule touches (panel accumulator
        # + the plain version's per-triple products) — the working-set
        # basis for batch_chunk(), as in the JAX package.
        bm = a_shape[1] if len(a_shape) == 3 else 0
        self._bn = b_shape[2] if len(b_shape) == 3 else 0
        self._per_set_rows = (
            schedule.n_panels * schedule.group + schedule.num_triples
        ) * bm
        self._runs = stage_runs(schedule, self.device)
        # The assembly map is the plan's *active* output map: the block-
        # structural map for output="block", the element-exact compact map
        # for output="compact"; every path gathers through it.
        self._gather = torch.from_numpy(assembly.gather).to(self.device)
        self._out_rows = int(assembly.shape[0])
        self._indptr_host = np.asarray(assembly.indptr)
        self._row_ids: Optional[torch.Tensor] = None
        self._a_inv = self._stage_inverse(a_scatter, a_shape)
        self._b_inv = self._stage_inverse(b_scatter, b_shape)

    def _stage_inverse(self, scatter, shape):
        if scatter is None:
            return None
        inv = _invert_scatter(np.asarray(scatter), int(np.prod(shape)))
        return torch.from_numpy(inv).to(self.device)

    @property
    def can_rebind(self) -> bool:
        """True for element plans: both operands rebind from value
        vectors on the device."""
        return self._a_inv is not None and self._b_inv is not None

    def set_chunk_bytes(self, chunk_bytes: Optional[int]) -> None:
        """Re-resolve the chunk policy with a new per-set budget;
        ``REPRO_SPGEMM_CHUNK_BYTES`` still wins (:func:`resolve_chunk_bytes`)."""
        self._chunk_policy = resolve_chunk_bytes(chunk_bytes, self.device)

    def constants(self) -> list:
        """The device tensors every numeric call reads: schedule runs,
        scatter inverses, gather map."""
        runs = self._runs
        out = [runs.ptr, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row, self._gather]
        return out + [t for t in (self._a_inv, self._b_inv) if t is not None]

    def batch_chunk(
        self,
        small_set_bytes: Optional[int] = None,
        cache_bytes: Optional[int] = None,
    ) -> int:
        """Max batch elements per fused device call.

        Sets whose working bytes (``4 * per_set_rows * bn``) fit the
        per-set budget are fused up to ``cache_bytes`` per call; larger
        sets run one per call. Both knobs default to the resolved
        per-device policy.
        """
        if small_set_bytes is None:
            small_set_bytes = self._chunk_policy[0]
        if cache_bytes is None:
            cache_bytes = self._chunk_policy[1]
        per_set = 4 * self._per_set_rows * self._bn
        if per_set <= small_set_bytes:
            return max(1, cache_bytes // max(per_set, 1))
        return 1

    def device_indptr(self) -> torch.Tensor:
        """Device-resident CSR ``indptr`` (int32) of the active output map
        (:func:`~repro_torch.kernels.gustavson_spgemm.compact_csr_indptr`
        over the map's static per-value row ids, staged once). Equals the
        plan's host ``indptr`` elementwise."""
        if self._row_ids is None:
            self._row_ids = torch.from_numpy(np.repeat(
                np.arange(self._out_rows, dtype=np.int64),
                np.diff(self._indptr_host),
            )).to(self.device)
        return compact_csr_indptr(self._row_ids, m=self._out_rows)

    def run(self, a_blocks, b_blocks) -> torch.Tensor:
        """Packed blocks -> packed C values (plan's backend)."""
        return numeric_core(
            a_blocks, b_blocks, self._runs, self._gather, backend=self.backend,
        )

    def run_values(self, a_vals, b_vals) -> torch.Tensor:
        """[nnz] value vectors -> packed C values, rebind included."""
        return numeric_core_values(
            a_vals, b_vals, self._a_inv, self._b_inv, self._runs, self._gather,
            a_shape=self.a_shape, b_shape=self.b_shape, backend=self.backend,
        )

    def run_batch(self, a_vals, b_vals, *, rebind: bool) -> torch.Tensor:
        """Batched values (on ``device``) -> packed C values [batch, nnz_c]."""
        return numeric_core_batch(
            a_vals, b_vals, self._a_inv, self._b_inv, self._runs, self._gather,
            a_shape=self.a_shape, b_shape=self.b_shape, rebind=rebind,
            backend=self.backend,
        )

    # -- pipeline protocol (stage-split; only pipe_collect blocks) ----------
    #
    # ``mode`` for pipe_stage: "values" ([nnz] vectors, element plans),
    # "blocks" (packed blocks, block plans), "batch_values" ([batch, nnz])
    # or "batch_blocks" ([batch, slots, ...]). Operands are CPU tensors
    # (pinned, for a CUDA executor) or tensors already on the device.
    # ``mode`` for kernel/assemble/collect: "single" or "batch".

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def pipe_stage(self, a, b, *, mode: str):
        """Host-to-device copy (asynchronous from pinned memory) and the
        value rebind; returns the staged packed blocks."""
        a, b = self._to_device(a), self._to_device(b)
        if mode == "values":
            return (bind_core(a, self._a_inv, shape=self.a_shape),
                    bind_core(b, self._b_inv, shape=self.b_shape))
        if mode == "blocks":
            return a, b
        if mode == "batch_values":
            return (bind_batch_core(a, self._a_inv, shape=self.a_shape),
                    bind_batch_core(b, self._b_inv, shape=self.b_shape))
        if mode == "batch_blocks":
            return _stack_blocks(a, self.a_shape), _stack_blocks(b, self.b_shape)
        raise ValueError(f"unknown stage mode {mode!r}")

    def pipe_kernel(self, staged, *, mode: str):
        """The scheduled kernel over staged blocks."""
        a_blocks, b_blocks = staged
        if mode == "single":
            return kernel_core(a_blocks, b_blocks, self._runs, backend=self.backend)
        return kernel_batch_core(a_blocks, b_blocks, self._runs, a_slots=self.a_shape[0],
                                 backend=self.backend)

    def pipe_assemble(self, panels, *, mode: str):
        """The output-assembly gather."""
        if mode == "single":
            return assemble_core(panels, self._gather)
        return assemble_batch_core(panels, self._gather)

    def pipe_download(self, packed: torch.Tensor):
        """Start the device-to-host copy of packed C values: on a CUDA
        executor into a fresh pinned tensor, with an event recorded after
        the copy on the current stream; on the CPU the values themselves."""
        if packed.device.type != "cuda":
            return packed
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Download(host, event)

    def pipe_collect(self, pending, *, mode: str) -> torch.Tensor:
        """Packed C values on the host: waits for the step's copy (the only
        blocking call of the protocol)."""
        if isinstance(pending, _Download):
            pending.event.synchronize()
            return pending.host
        return pending
