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
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)

__all__ = [
    "CHUNK_BYTES_ENV",
    "SpGEMMExecutor",
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


def _bind(vals, inv, shape):
    """Device-side value rebind as one gather through the precomputed
    scatter inverse. Positions outside the pattern read the zero pad."""
    pad = torch.cat([vals, vals.new_zeros(1)])
    return pad.index_select(0, inv).reshape(shape)


def _bind_batch(vals, inv, shape):
    """Batched value rebind: one gather per batch row through the shared
    scatter inverse, stacked along the slot axis."""
    bsz = vals.shape[0]
    pad = torch.cat([vals, vals.new_zeros((bsz, 1))], dim=1)
    return pad.index_select(1, inv).reshape((bsz * shape[0],) + tuple(shape[1:]))


def numeric_core(a_blocks, b_blocks, runs, gather, *, backend):
    """Functional numeric phase: packed blocks -> packed C values."""
    panels = _run_schedule(a_blocks, b_blocks, runs, backend=backend)
    return panels.reshape(-1).index_select(0, gather)


def numeric_core_values(
    a_vals, b_vals, a_inv, b_inv, runs, gather, *, a_shape, b_shape, backend,
):
    """Numeric phase from [nnz] value vectors: rebind + kernel + assembly."""
    return numeric_core(
        _bind(a_vals, a_inv, a_shape), _bind(b_vals, b_inv, b_shape),
        runs, gather, backend=backend,
    )


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
    bsz = a_vals.shape[0]
    if rebind:
        a_blocks = _bind_batch(a_vals, a_inv, a_shape)
        b_blocks = _bind_batch(b_vals, b_inv, b_shape)
    else:
        a_blocks = a_vals.reshape((bsz * a_shape[0],) + tuple(a_shape[1:]))
        b_blocks = b_vals.reshape((bsz * b_shape[0],) + tuple(b_shape[1:]))
    panels = _run_schedule_batch(a_blocks, b_blocks, runs, bsz, backend=backend)
    return panels.reshape(bsz, -1).index_select(1, gather)


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
        self._gather = torch.from_numpy(assembly.gather).to(self.device)
        self._out_rows = int(assembly.shape[0])
        self._indptr_host = np.asarray(assembly.indptr)
        self._a_inv = self._stage_inverse(a_scatter, a_shape)
        self._b_inv = self._stage_inverse(b_scatter, b_shape)

    def _stage_inverse(self, scatter, shape):
        if scatter is None:
            return None
        inv = _invert_scatter(np.asarray(scatter), int(np.prod(shape)))
        return torch.from_numpy(inv).to(self.device)

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
        """Device-resident CSR ``indptr`` (int32) of the output map:
        ``bincount`` of the static per-value row ids + ``cumsum``. Equals
        the plan's host ``indptr`` elementwise."""
        row_ids = torch.from_numpy(np.repeat(
            np.arange(self._out_rows, dtype=np.int64),
            np.diff(self._indptr_host),
        )).to(self.device)
        counts = torch.bincount(row_ids, minlength=self._out_rows)
        indptr = torch.zeros(self._out_rows + 1, dtype=torch.int32, device=self.device)
        indptr[1:] = torch.cumsum(counts, 0)
        return indptr

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
