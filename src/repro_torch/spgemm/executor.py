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

Every stage is shape-static, so the same stages run a batch of value sets
over a leading axis (``run_batch``, the engine behind
``SpGEMMPlan.execute_batch``): on the ``cuda`` backend the batch is a grid
dimension of one kernel launch
(:func:`~repro_torch.kernels.gustavson_spgemm.spgemm_scheduled_batch`), on
``torch`` a schedule with each element's indices offset. Both keep each
element's accumulation order, so a batch equals a loop of single executes
bit for bit. :class:`SpGEMMExecutor` holds a plan's device-resident
constants (schedule runs, scatter inverses, gather map — copied to the
device once). A scatter inverse or gather map that is the identity (at
tile 1, where the packed blocks are the values and the panels are C's
entries) is not staged, and its gather is skipped.

**One way to the device.** An executor takes the operands of a plan in
the plan's value shape — ``[nnz]`` vectors for element plans, packed
blocks for block plans — and decides, from the scatters it was built
with, whether stage 1 gathers values into blocks on the device.
``stage`` copies operands into the layout the kernels read (the plan keeps
what it stages and hands it back); ``run`` and ``run_batch`` take operands
staged or not.

**Stage-split pipeline surface.** Each stage is also a function of its
own (``bind_core`` / ``kernel_core`` / ``assemble_core`` and their batched
forms), and ``run`` / ``run_batch`` are the protocol's device steps back to
back, so a step run stage by stage is the same sequence of operations.
:class:`SpGEMMExecutor` carries the pipeline protocol over them (``mode``
is ``"single"`` or ``"batch"``)::

    staged = ex.pipe_stage(a, b, mode=mode)      # host-to-device copy + rebind
    panels = ex.pipe_kernel(staged, mode=mode)   # the scheduled kernel
    packed = ex.pipe_assemble(panels, mode=mode) # the assembly gather
    pend   = _download(packed)                   # device-to-host copy, started
    out    = _collect(pend)                      # the ONLY blocking call

On a CUDA executor every step but ``_collect`` only enqueues work on the
current stream: host operands come from pinned memory and go to the card
with ``non_blocking`` copies, and ``_download`` copies C's values into a
fresh pinned host tensor and records an event, which ``_collect`` waits
on. A caller that runs each step on a stream of its own
(:class:`repro_torch.spgemm.pipeline.SpGEMMPipeline`) overlaps step
``s + 1``'s copies and kernel with step ``s``'s: the paper's double
buffer. On the CPU every step runs at once and ``_collect`` returns its
values.

**Sharded plans.** :class:`ShardedSpGEMMExecutor` has the same surface
over a schedule partitioned at block-row-group boundaries
(:func:`~repro_torch.core.schedule.partition_spgemm_schedule`): each
shard is one program of its own on its device, running the same stage
cores on its rebased schedule slice, and C is the concatenation of the
shards' packed segments.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import AssemblyMap, ScheduleShard, SpGEMMSchedule
from repro_torch.kernels import ref
from repro_torch.kernels.gustavson_spgemm import (
    ScheduleRuns,
    compact_csr_indptr,
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)
from repro_torch.runtime.heartbeat import default_registry

__all__ = [
    "CHUNK_BYTES_ENV",
    "ShardedSpGEMMExecutor",
    "SpGEMMExecutor",
    "assemble_batch_core",
    "assemble_core",
    "bind_batch_core",
    "bind_core",
    "kernel_batch_core",
    "kernel_core",
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
#   repro_torch.core.tuning.measure_chunk_knee(device="cuda") measures the
#   card's knee (PERF.md records its runs); the derived row stays until
#   two runs agree on a replacement.
#
# The autotuner brackets a plan device's own row; the env knob overrides
# any row without a code change.
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


def _is_identity(index: Optional[np.ndarray], size: int) -> bool:
    """Whether ``index`` maps position ``i`` to ``i`` over all ``size``
    positions (at tile 1 the rebind and the assembly do nothing else):
    such a gather is skipped, as it would copy its input unchanged."""
    if index is None or index.shape[0] != size:
        return False
    # A sample first: a block map of this size fails it without a full pass.
    step = max(1, size // 1024)
    if not np.array_equal(index[::step], np.arange(0, size, step)):
        return False
    return bool((np.diff(index) == 1).all())


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
# An executor's run and run_batch are compositions of these, so a step run
# stage by stage (the pipeline) runs exactly the operations of a fused call.


def bind_core(vals, inv, *, shape):
    """Stage 1 (element plans): [nnz] values -> packed blocks, as one
    gather through the precomputed scatter inverse. Positions outside the
    pattern read the zero pad. ``inv=None`` is the identity (the values
    are the blocks)."""
    if inv is None:
        return vals.reshape(shape)
    pad = torch.cat([vals, vals.new_zeros(1)])
    return pad.index_select(0, inv).reshape(shape)


def bind_batch_core(vals, inv, *, shape):
    """Stage 1, batched: [batch, nnz] values -> stacked packed blocks, one
    gather per batch row through the shared scatter inverse."""
    bsz = vals.shape[0]
    if inv is None:
        return vals.reshape((bsz * shape[0],) + tuple(shape[1:]))
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
    """Stage 3: output panels -> packed C values (one static gather;
    ``gather=None`` is the identity)."""
    if gather is None:
        return panels.reshape(-1)
    return panels.reshape(-1).index_select(0, gather)


def assemble_batch_core(panels, gather):
    """Stage 3, batched: one gather per batch element through the shared
    map: ``[batch, nnz_c]``."""
    if gather is None:
        return panels.reshape(panels.shape[0], -1)
    return panels.reshape(panels.shape[0], -1).index_select(1, gather)


def _stack_blocks(vals, shape):
    """Packed blocks, batched (``[batch, slots, ...]``) or not, ->
    ``[batch * slots, ...]``."""
    return vals.reshape((-1,) + tuple(shape[1:]))


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh page-locked copy of the CPU tensor ``t`` (from PyTorch's
    caching host allocator, which reuses a block only after the copies
    recorded on it have completed), filled by one plain memcpy: torch's
    parallel copy is slow and uneven on a busy host."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if t.numel():
        np.copyto(out.reshape(-1).view(torch.uint8).numpy(),
                  t.contiguous().reshape(-1).view(torch.uint8).numpy())
    return out


def _to_devices(t: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """``t`` on each of ``devices`` (not copied where it is already there).
    On the card a host tensor goes through page-locked memory, copied there
    once unless it is page-locked already, so no copy blocks the host."""
    if (t.device.type == "cpu" and any(d.type == "cuda" for d in devices)
            and not t.is_pinned()):
        t = _pinned_copy(t)
    return [t.to(d, non_blocking=True) for d in devices]


class _Download:
    """A device-to-host copy in flight: the pinned host tensor it writes
    and the event recorded after it on the copying stream."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


def _download(packed: torch.Tensor):
    """Start the device-to-host copy of ``packed`` into a fresh pinned
    tensor and record an event after it on the current stream (CUDA), or
    hand back the values themselves (CPU). The counter
    ``spgemm.d2h_pinned_bytes`` counts the bytes copied so."""
    if packed.device.type != "cuda":
        return packed
    default_registry().counter("spgemm.d2h_pinned_bytes").inc(packed.nbytes)
    return _copy_out(packed)


def _copy_out(t: torch.Tensor) -> "_Download":
    """:func:`_download` of a CUDA tensor, counted nowhere (the plan's own
    symbolic arrays, which are no result)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    # The copy runs on the current stream of t's device, which need not be
    # the current device: the event goes on that same stream.
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return _Download(host, event)


def _collect(pending) -> torch.Tensor:
    """Wait for a :func:`_download` and return its host values."""
    if isinstance(pending, _Download):
        pending.event.synchronize()
        return pending.host
    return pending


class _Executor:
    """What both executors share: the chunk policy of a batch and ``run``
    / ``run_batch``, which are the pipeline protocol's device steps back to
    back (``pipe_stage``, ``pipe_kernel``, ``pipe_assemble``, each
    executor's own)."""

    @property
    def can_rebind(self) -> bool:
        """True for element plans: both operands are ``[nnz]`` value
        vectors, bound into packed blocks on the device."""
        return self._element

    def set_chunk_bytes(self, chunk_bytes: Optional[int]) -> None:
        """Re-resolve the chunk policy with a new per-set budget;
        ``REPRO_SPGEMM_CHUNK_BYTES`` still wins (:func:`resolve_chunk_bytes`)."""
        self._chunk_policy = resolve_chunk_bytes(chunk_bytes, self.device)

    def batch_chunk(
        self,
        small_set_bytes: Optional[int] = None,
        cache_bytes: Optional[int] = None,
    ) -> int:
        """Max batch elements per fused device call.

        Sets whose working bytes (``4 * per_set_rows * bn``; a sharded
        executor's largest shard's) fit the per-set budget are fused up to
        ``cache_bytes`` per call; larger sets run one per call. Both knobs
        default to the resolved per-device policy.
        """
        if small_set_bytes is None:
            small_set_bytes = self._chunk_policy[0]
        if cache_bytes is None:
            cache_bytes = self._chunk_policy[1]
        per_set = 4 * self._per_set_rows * self._bn
        if per_set <= small_set_bytes:
            return max(1, cache_bytes // max(per_set, 1))
        return 1

    def run(self, a, b) -> torch.Tensor:
        """One value set in the plan's value shape (host tensors, tensors
        on the device, or what :meth:`stage` made of them) -> packed C
        values ``[nnz_c]``, on the executor's device."""
        return self._steps(a, b, "single")

    def run_batch(self, a, b) -> torch.Tensor:
        """Value sets stacked on a leading batch axis -> packed C values
        ``[batch, nnz_c]``: one K2 launch (per launching shard)."""
        return self._steps(a, b, "batch")

    def _steps(self, a, b, mode: str) -> torch.Tensor:
        staged = self.pipe_stage(a, b, mode=mode)
        return self.pipe_assemble(self.pipe_kernel(staged, mode=mode), mode=mode)


class SpGEMMExecutor(_Executor):
    """A plan's numeric phase with device-resident constants.

    Copies the schedule runs, the scatter inverses and the assembly gather
    map to ``device`` once (an identity map as ``None``: its gather is
    skipped; a map built on the device passes its gather as ``gather``,
    which is not copied); ``run``/``run_batch`` then call the stage cores
    with no per-call host work beyond operand transfer. Built with both scatters
    (an element plan), it binds ``[nnz]`` value vectors into packed blocks
    on the device; without them its operands are the packed blocks.
    ``pairs`` is the scalar products one launch computes: the element pairs
    at tile 1, the block fill included at larger tiles; ``triples`` the
    block products (``pairs`` is ``triples`` x bm·bk·bn).
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
        gather: Optional[torch.Tensor] = None,
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
        bk = a_shape[2] if len(a_shape) == 3 else 0
        self.triples = schedule.num_triples
        self.pairs = self.triples * bm * bk * self._bn
        self._runs = stage_runs(schedule, self.device)
        # The assembly map is the plan's *active* output map: the block-
        # structural map for output="block", the element-exact compact map
        # for output="compact"; every path gathers through it. ``gather``
        # is its gather already on the device (built there), not sent again.
        flat = schedule.n_panels * schedule.group * bm * self._bn
        self._gather = None if _is_identity(assembly.gather, flat) else (
            gather if gather is not None else torch.from_numpy(assembly.gather).to(self.device))
        self._out_rows = int(assembly.shape[0])
        self._indptr_host = np.asarray(assembly.indptr)
        self._row_ids: Optional[torch.Tensor] = None
        self._element = a_scatter is not None and b_scatter is not None
        self._a_inv = self._stage_inverse(a_scatter, a_shape)
        self._b_inv = self._stage_inverse(b_scatter, b_shape)

    def _stage_inverse(self, scatter, shape):
        if scatter is None or _is_identity(np.asarray(scatter), int(np.prod(shape))):
            return None
        inv = _invert_scatter(np.asarray(scatter), int(np.prod(shape)))
        return torch.from_numpy(inv).to(self.device)

    def staged_runs(self) -> dict:
        """The schedule runs the kernel reads, as staged on the device:
        ``{0: ScheduleRuns}`` (keyed like the sharded executor's, by
        shard)."""
        return {0: self._runs}

    def constants(self) -> list:
        """The device tensors every numeric call reads: schedule runs,
        scatter inverses, gather map."""
        runs = self._runs
        out = [runs.ptr, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row]
        return out + [t for t in (self._gather, self._a_inv, self._b_inv) if t is not None]

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

    def stage(self, a, b):
        """Operands in the plan's value shape, single or batched -> the
        layout the kernel reads: each on ``device``. ``None`` stays
        ``None``; one tensor passed as both operands is copied once."""
        a_dev = None if a is None else _to_devices(a, [self.device])[0]
        b_dev = a_dev if b is a else None if b is None else _to_devices(b, [self.device])[0]
        return a_dev, b_dev

    # -- pipeline protocol (stage-split; only _collect blocks) --------------
    #
    # Operands are CPU tensors (pinned, for a CUDA executor), tensors on the
    # device, or what stage() made of them; ``mode`` is "single" or "batch".

    def pipe_stage(self, a, b, *, mode: str):
        """Host-to-device copy (asynchronous from pinned memory) and stage
        1: element plans bind their values into packed blocks; returns the
        packed blocks (stacked over the batch)."""
        a, b = self.stage(a, b)
        if not self._element:
            return _stack_blocks(a, self.a_shape), _stack_blocks(b, self.b_shape)
        bind = bind_core if mode == "single" else bind_batch_core
        return (bind(a, self._a_inv, shape=self.a_shape),
                bind(b, self._b_inv, shape=self.b_shape))

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


class _ShardPart:
    """One launching shard's device constants: its index among the
    plan's shards, its schedule runs and output gather map, its A slot and
    element ranges in the plan's packed A, and (element plans) the scatter
    inverse into its own A slots."""

    __slots__ = ("shard", "device", "runs", "gather", "a_lo", "a_hi", "e_lo", "e_hi",
                 "a_shape", "a_inv")

    def __init__(self, shard, device, runs, gather, a_lo, a_hi, e_lo, e_hi, a_shape, a_inv):
        self.shard = shard
        self.device = device
        self.runs = runs
        self.gather = gather
        self.a_lo, self.a_hi = a_lo, a_hi
        self.e_lo, self.e_hi = e_lo, e_hi
        self.a_shape = a_shape
        self.a_inv = a_inv


class ShardedSpGEMMExecutor(_Executor):
    """Numeric phase of a sharded plan: one program per shard.

    Drop-in for :class:`SpGEMMExecutor` on the plan side (``stage``,
    ``run``, ``run_batch``, ``batch_chunk``, ``device_indptr``,
    ``can_rebind``, ``set_chunk_bytes`` and the ``pipe_*`` stages). Where
    the JAX package stacks the shards into one ``shard_map`` program over
    a mesh axis, each shard here runs the single executor's stage cores on
    its own device and its own rebased schedule slice, through the same
    kernel (K1, or K2 for a batch), launched once per launching shard.

    Layout:

    * A — row-sharded: shard ``i`` reads packed slots ``[a_lo_i, a_hi_i)``
      (elements ``[e_lo_i, e_hi_i)``), contiguous because BCSV packs blocks
      group-major;
    * B — replicated, once per *distinct* device (shards sharing a device
      share one copy and one rebind);
    * C — row-sharded: each shard gathers its packed segment through its
      own output map, and the segments, contiguous ascending row ranges,
      are concatenated on the plan's device in shard order.

    A shard launches when it has triples and output values. Empty shards
    (more shards than block-row groups, or a row range without products)
    launch nothing and contribute an empty segment: a CUDA launch with an
    empty grid is an error. Each launching shard's triples keep their
    parent order after rebasing, so every output tile sums the same
    triples in the same order as the single plan's: the result is bitwise
    equal to it.
    """

    def __init__(
        self,
        *,
        shards: Sequence[ScheduleShard],
        assemblies: Sequence[AssemblyMap],
        devices: Sequence[torch.device],
        backend: str,
        a_scatter: Optional[np.ndarray] = None,
        b_scatter: Optional[np.ndarray] = None,
        a_shape: Tuple[int, ...] = (),
        b_shape: Tuple[int, ...] = (),
        a_val_bounds: Optional[np.ndarray] = None,
        chunk_bytes: Optional[int] = None,
    ):
        if not (len(shards) == len(assemblies) == len(devices)):
            raise ValueError(
                f"{len(shards)} shards, {len(assemblies)} output maps and "
                f"{len(devices)} devices"
            )
        self.backend = backend
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self._chunk_policy = resolve_chunk_bytes(chunk_bytes, self.device)
        self.a_shape = tuple(a_shape)
        self.b_shape = tuple(b_shape)
        self.group = shards[0].schedule.group
        bm = a_shape[1] if len(a_shape) == 3 else 0
        block = tuple(a_shape[1:])
        self._bn = b_shape[2] if len(b_shape) == 3 else 0
        # Block and scalar products of one run over every shard (as
        # SpGEMMExecutor's).
        self.triples = sum(sh.num_triples for sh in shards)
        self.pairs = self.triples * int(np.prod(block)) * self._bn
        self._assemblies = list(assemblies)
        element = self._element = a_scatter is not None and b_scatter is not None
        if element and a_val_bounds is None:
            raise ValueError("element shards need a_val_bounds")
        self._parts: List[_ShardPart] = []
        rows = 0
        for i, (sh, asm, dev) in enumerate(zip(shards, assemblies, self.devices)):
            rows = max(rows, (sh.n_panels * self.group + sh.num_triples) * bm)
            if not (sh.num_triples and asm.nnz):
                continue
            local = (sh.a_hi - sh.a_lo,) + block
            e_lo = e_hi = 0
            a_inv = None
            if element:
                e_lo, e_hi = int(a_val_bounds[i]), int(a_val_bounds[i + 1])
                flat = int(np.prod(local))
                pos = np.asarray(a_scatter[e_lo:e_hi], np.int64) - sh.a_lo * int(np.prod(block))
                # Elements of A blocks outside the shard's slot range feed
                # no triple (no matching B block): they are not bound.
                sel = (pos >= 0) & (pos < flat)
                inv = np.full(flat, e_hi - e_lo, np.int32)
                inv[pos[sel]] = np.arange(e_hi - e_lo, dtype=np.int32)[sel]
                a_inv = torch.from_numpy(inv).to(dev)
            self._parts.append(_ShardPart(
                i, dev, stage_runs(sh.schedule, dev), torch.from_numpy(asm.gather).to(dev),
                sh.a_lo, sh.a_hi, e_lo, e_hi, local, a_inv,
            ))
        # Per-set rows of the largest shard: the working-set basis of
        # batch_chunk (each device holds only its own shards' panels).
        self._per_set_rows = rows
        self._b_devices = list(dict.fromkeys(p.device for p in self._parts))
        self._b_inv: Dict[torch.device, torch.Tensor] = {}
        if element:
            inv = _invert_scatter(np.asarray(b_scatter), int(np.prod(b_shape)))
            self._b_inv = {d: torch.from_numpy(inv).to(d) for d in self._b_devices}
        self._row_ids: Optional[torch.Tensor] = None

    @property
    def n_launching(self) -> int:
        """Shards that launch the kernel (those with triples and output
        values): the launches of one ``run`` or batch chunk."""
        return len(self._parts)

    def staged_runs(self) -> dict:
        """The schedule runs each launching shard's kernel reads, as
        staged on its device: ``{shard index: ScheduleRuns}``."""
        return {p.shard: p.runs for p in self._parts}

    def constants(self) -> list:
        """Every device tensor the numeric calls read."""
        out = []
        for p in self._parts:
            r = p.runs
            out += [r.ptr, r.a_slot, r.b_slot, r.panel, r.sub_row, p.gather]
            if p.a_inv is not None:
                out.append(p.a_inv)
        return out + list(self._b_inv.values())

    def device_indptr(self) -> torch.Tensor:
        """Plan-wide device CSR ``indptr`` (int32) on the plan's device.
        Shard row ranges are contiguous and ascending, so the plan-wide
        row ids are the offset concatenation of the shards' own, in the
        order the segments are concatenated."""
        if self._row_ids is None:
            ids, off = [], 0
            for asm in self._assemblies:
                n_rows = int(asm.shape[0])
                ids.append(off + np.repeat(np.arange(n_rows, dtype=np.int64),
                                           np.diff(np.asarray(asm.indptr))))
                off += n_rows
            self._out_rows = off
            self._row_ids = torch.from_numpy(
                np.concatenate(ids) if ids else np.zeros(0, np.int64)).to(self.device)
        return compact_csr_indptr(self._row_ids, m=self._out_rows)

    def stage(self, a, b, *, batch: bool = False):
        """Operands in the plan's value shape -> the layout the shards
        read: an element plan's value vectors once per distinct device (a
        dict; one tensor passed as both operands, once), a block plan's A
        as each launching shard's slot slice on its device (a list; only
        the slice is copied) and its B once per distinct device. ``None``
        stays ``None``, and an operand already laid out passes through."""

        def lay(t, slices):
            if not isinstance(t, torch.Tensor):
                return t
            if slices:
                return [_to_devices(t[:, p.a_lo:p.a_hi] if batch else t[p.a_lo:p.a_hi],
                                    [p.device])[0] for p in self._parts]
            return dict(zip(self._b_devices, _to_devices(t, self._b_devices)))

        a_on = lay(a, not self._element)
        return a_on, a_on if b is a and self._element else lay(b, False)

    def _concat(self, segments: list, batch: Optional[int]) -> torch.Tensor:
        """The shards' packed segments, in shard order, on the plan's
        device: one contiguous C (``[nnz_c]``, or ``[batch, nnz_c]``)."""
        segments = [s.to(self.device, non_blocking=True) for s in segments]
        if not segments:
            shape = (0,) if batch is None else (batch, 0)
            return torch.zeros(shape, dtype=torch.float32, device=self.device)
        return torch.cat(segments, dim=-1)

    # -- pipeline protocol (same surface as SpGEMMExecutor) ----------------

    def pipe_stage(self, a, b, *, mode: str):
        """Copies to each distinct device and each shard's stage 1;
        returns ``(a blocks per shard, B blocks per device, batch or
        None)``."""
        batch = mode == "batch"
        bsz = int(a.shape[0]) if batch else None
        a_on, b_on = self.stage(a, b, batch=batch)
        if self._element:
            bind = bind_batch_core if batch else bind_core
            b_blk = {d: bind(b_on[d], self._b_inv[d], shape=self.b_shape) for d in b_on}
            a_blk = [bind(a_on[p.device][..., p.e_lo:p.e_hi], p.a_inv, shape=p.a_shape)
                     for p in self._parts]
        else:
            b_blk = {d: _stack_blocks(b_on[d], self.b_shape) for d in b_on}
            a_blk = [_stack_blocks(x, p.a_shape) for p, x in zip(self._parts, a_on)]
        return a_blk, b_blk, bsz

    def pipe_kernel(self, staged, *, mode: str):
        """Every launching shard's kernel: one launch each, on its own
        schedule."""
        a_blk, b_blk, bsz = staged
        if mode == "batch":
            panels = [kernel_batch_core(a, b_blk[p.device], p.runs, a_slots=p.a_shape[0],
                                        backend=self.backend)
                      for p, a in zip(self._parts, a_blk)]
        else:
            panels = [kernel_core(a, b_blk[p.device], p.runs, backend=self.backend)
                      for p, a in zip(self._parts, a_blk)]
        return panels, bsz

    def pipe_assemble(self, panels, *, mode: str):
        """Every shard's gather, then the concatenation."""
        panels, bsz = panels
        if mode == "single":
            segs = [assemble_core(x, p.gather) for p, x in zip(self._parts, panels)]
        else:
            segs = [assemble_batch_core(x, p.gather) for p, x in zip(self._parts, panels)]
        return self._concat(segs, bsz)
