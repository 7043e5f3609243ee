"""Block-Gustavson SpGEMM kernel: the wrappers of ``csrc/gustavson_spgemm.cu``.

The paper's FPGA kernel (NUM_PE processing elements sharing a B-row buffer)
runs on the GPU as one thread block per (panel, sub_row) output tile: the
block walks that tile's triples of the static schedule
(:func:`repro_torch.core.schedule.panel_runs`) as a stream of 32-deep
chunks (16-deep where the tile's depth needs it) through a ring of
shared-memory stages filled by asynchronous copies, keeps the float32 sum
on chip and writes the tile once.
:func:`spgemm_scheduled` runs one value set; :func:`spgemm_scheduled_batch`
runs a batch of value sets over the shared schedule, with the batch
element as a grid dimension, and equals a loop of single calls bit for
bit. Blocks are float32 or bfloat16 (a plan built on bfloat16 values
stages bfloat16 blocks); the result is float32 either way, each element a
float32 FMA chain over the tile's triples in order, k ascending.

Each wrapper launches the CUDA kernel for CUDA tensors, on the current
stream, and raises on anything it does not accept. For CPU tensors it
computes the same result with the plain PyTorch version
(:mod:`repro_torch.kernels.ref`). Each wrapper's ``launches`` attribute
counts its kernel launches, ``bf16_launches`` those with bfloat16 blocks,
and ``stream_launches`` (a ``Counter`` keyed by the ``cudaStream_t``
handle) the streams they went to.

:func:`compact_row_counts` and :func:`compact_csr_indptr` are the device
half of the output bookkeeping: C's CSR row pointers from the output
map's static row ids (``bincount`` + ``cumsum``; no hand-written kernel,
as the JAX package's counterparts are a segment sum and a ``cumsum``).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core.schedule import SpGEMMSchedule, build_spgemm_schedule, panel_runs
from repro_torch.kernels import ref
from repro_torch.kernels._build import load_gustavson
from repro_torch.sparse.convert import to_bcsr, to_bcsv
from repro_torch.sparse.formats import BCSR, BCSV

__all__ = [
    "ScheduleRuns",
    "compact_csr_indptr",
    "compact_row_counts",
    "pad_schedule_arrays",
    "runs_case",
    "spgemm_scheduled",
    "spgemm_scheduled_batch",
    "stage_runs",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class ScheduleRuns:
    """A triple schedule regrouped into per-tile runs, on one device.

    Tile ``i = panel * group + sub_row`` owns entries ``ptr[i]:ptr[i+1]``
    of the run-ordered arrays. ``panel`` and ``sub_row`` (run order) serve
    the plain version; the kernel reads ``ptr``, ``a_slot`` and ``b_slot``.
    """

    ptr: torch.Tensor  # [n_panels * group + 1] int32
    a_slot: torch.Tensor  # [T] int32
    b_slot: torch.Tensor  # [T] int32
    panel: torch.Tensor  # [T] int32
    sub_row: torch.Tensor  # [T] int32
    n_panels: int
    group: int

    @property
    def device(self) -> torch.device:
        return self.ptr.device


def stage_runs(schedule: SpGEMMSchedule, device) -> ScheduleRuns:
    """Regroup ``schedule`` by output tile and copy it to ``device``."""
    ptr, order = panel_runs(schedule)
    if ptr[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"{int(ptr[-1])} triples exceed int32 run offsets")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    return ScheduleRuns(
        ptr=put(ptr),
        a_slot=put(schedule.a_slot[order]),
        b_slot=put(schedule.b_slot[order]),
        panel=put(schedule.panel[order]),
        sub_row=put(schedule.sub_row[order]),
        n_panels=schedule.n_panels,
        group=schedule.group,
    )


def pad_schedule_arrays(
    a_slot: np.ndarray,
    b_slot: np.ndarray,
    panel: np.ndarray,
    sub_row: np.ndarray,
    start: np.ndarray,
    n_panels: int,
    pad_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad a triple schedule to a fixed length with dummy-panel triples,
    as the JAX package pads its kernel's grid.

    Padding triples write to panel ``n_panels`` (an extra scratch panel no
    gather reads), with start=1 so they never accumulate garbage. The CUDA
    kernel needs none of this (its grid reads per-tile runs); the port
    keeps it for the per-shard stacks of
    :func:`repro_torch.core.schedule.stack_shard_schedules`, held against
    the JAX package's arrays.
    """
    t = int(a_slot.shape[0])
    t_pad = pad_to if pad_to is not None else max(1, t)
    if t_pad < t:
        raise ValueError(f"pad_to={t_pad} < schedule length {t}")
    pad = t_pad - t

    def _p(x, fill):
        return np.concatenate([x, np.full(pad, fill, x.dtype)]) if pad else x

    return (
        _p(a_slot, 0),
        _p(b_slot, 0),
        _p(panel, n_panels),
        _p(sub_row, 0),
        _p(start, 1),
        t_pad,
    )


def runs_case(tile, integer: bool, seed: int = 11) -> tuple[BCSV, BCSR, SpGEMMSchedule]:
    """A check case for the kernel's run handling: one panel of four
    sub-rows (group 4) whose tiles run 0, 1, 3 and 8 triples. A's block
    rows hold 0, 1, 3 and 8 of its 8 block columns, B is one block column
    of 8 nonzero blocks. Values are nonzero small integers (every float32
    sum exact, whatever the order) or normal values scaled by 1/sqrt(8 bk),
    so that outputs (sums of up to 8 bk products) are of order 1, where
    1e-5 bounds the float32 rounding of two summation orders."""
    bm, bk, bn = tile
    rng = np.random.default_rng(seed)
    ad = np.zeros((4 * bm, 8 * bk), np.float32)
    for row, count in enumerate((0, 1, 3, 8)):
        for col in rng.choice(8, count, replace=False):
            ad[row * bm:(row + 1) * bm, col * bk:(col + 1) * bk] = 1.0
    bd = np.ones((8 * bk, bn), np.float32)
    if integer:  # nonzero, so that no block drops out of the pattern
        ad *= rng.choice([-3, -2, -1, 1, 2, 3], ad.shape)
        bd *= rng.choice([-3, -2, -1, 1, 2, 3], bd.shape)
    else:
        ad *= (rng.standard_normal(ad.shape) / np.sqrt(8 * bk)).astype(np.float32)
        bd *= rng.standard_normal(bd.shape).astype(np.float32)
    a, b = to_bcsv(ad, (bm, bk), 4), to_bcsr(bd, (bk, bn))
    return a, b, build_spgemm_schedule(a, b)


def _check(a_blocks, b_blocks, runs: ScheduleRuns, bsz: int) -> None:
    if not isinstance(a_blocks, torch.Tensor) or not isinstance(b_blocks, torch.Tensor):
        raise TypeError("a_blocks and b_blocks must be torch tensors")
    if a_blocks.device != b_blocks.device or runs.device != a_blocks.device:
        raise ValueError(
            f"a_blocks ({a_blocks.device}), b_blocks ({b_blocks.device}) and "
            f"the schedule ({runs.device}) must be on one device"
        )
    if a_blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a_blocks.device}")
    if a_blocks.dtype not in _DTYPE_CODE or b_blocks.dtype != a_blocks.dtype:
        raise TypeError(
            f"blocks must both be float32 or both bfloat16, got "
            f"{a_blocks.dtype} and {b_blocks.dtype}"
        )
    if a_blocks.dim() != 3 or b_blocks.dim() != 3:
        raise ValueError("blocks must be [slots, rows, cols]")
    if a_blocks.shape[2] != b_blocks.shape[1]:
        raise ValueError(
            f"inner block dims differ: {tuple(a_blocks.shape)} x "
            f"{tuple(b_blocks.shape)}"
        )
    if bsz < 1 or a_blocks.shape[0] % bsz or b_blocks.shape[0] % bsz:
        raise ValueError(
            f"bsz={bsz} does not divide the slot counts "
            f"{a_blocks.shape[0]} / {b_blocks.shape[0]}"
        )
    if not (a_blocks.is_contiguous() and b_blocks.is_contiguous()):
        raise ValueError("blocks must be contiguous")
    if runs.ptr.shape[0] != runs.n_panels * runs.group + 1:
        raise ValueError("run offsets do not match n_panels * group")


def _no_panels(a_blocks, b_blocks, runs: ScheduleRuns, lead) -> torch.Tensor:
    """The empty result of a schedule without panels (nothing to launch)."""
    return torch.empty(
        lead + (0, runs.group * a_blocks.shape[1], b_blocks.shape[2]),
        dtype=torch.float32, device=a_blocks.device,
    )


def _stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(a_blocks, b_blocks, runs: ScheduleRuns, bsz: int) -> torch.Tensor:
    """Launch the kernel on the current stream; the schedule has tiles."""
    bm, bk = int(a_blocks.shape[1]), int(a_blocks.shape[2])
    bn = int(b_blocks.shape[2])
    for name, d in (("bm", bm), ("bk", bk), ("bn", bn)):
        if d % 16 or not 16 <= d <= 128:
            raise ValueError(f"the CUDA kernel takes tile dims that are multiples "
                             f"of 16 up to 128; {name}={d}")
    if bsz > 65535:
        raise ValueError(f"bsz={bsz} exceeds the grid's 65535 batch elements")
    for t in (a_blocks, b_blocks):
        if t.data_ptr() % 16:
            raise ValueError("block arrays must be 16-byte aligned")
    for t in (runs.ptr, runs.a_slot, runs.b_slot):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("schedule runs must be contiguous int32")
    out = torch.empty(
        (bsz, runs.n_panels, runs.group * bm, bn), dtype=torch.float32,
        device=a_blocks.device,
    )
    lib = load_gustavson()
    with torch.cuda.device(a_blocks.device):
        err = lib.gustavson_spgemm_launch(
            a_blocks.data_ptr(), b_blocks.data_ptr(), runs.ptr.data_ptr(),
            runs.a_slot.data_ptr(), runs.b_slot.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[a_blocks.dtype], bsz, runs.n_panels * runs.group,
            int(a_blocks.shape[0]) // bsz, int(b_blocks.shape[0]) // bsz,
            bm, bk, bn, _stream_handle(a_blocks),
        )
    if err != 0:
        raise RuntimeError(f"gustavson_spgemm kernel launch failed: cudaError_t {err}")
    return out


def spgemm_scheduled(
    a_blocks: torch.Tensor,  # [nnzb_a, bm, bk] packed BCSV blocks
    b_blocks: torch.Tensor,  # [nnzb_b, bk, bn] packed BCSR blocks
    runs: ScheduleRuns,
) -> torch.Tensor:
    """Run the scheduled block-Gustavson SpGEMM for one value set.

    Returns panels ``[n_panels, group*bm, bn]`` float32.
    """
    _check(a_blocks, b_blocks, runs, 1)
    if runs.n_panels == 0:
        return _no_panels(a_blocks, b_blocks, runs, ())
    if a_blocks.device.type == "cpu":
        return ref.spgemm_scheduled_ref(
            a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel,
            runs.sub_row, runs.n_panels, runs.group,
        )
    out = _launch(a_blocks, b_blocks, runs, 1)
    spgemm_scheduled.launches += 1
    spgemm_scheduled.bf16_launches += a_blocks.dtype == torch.bfloat16
    spgemm_scheduled.stream_launches[_stream_handle(a_blocks)] += 1
    return out[0]


def spgemm_scheduled_batch(
    a_blocks: torch.Tensor,  # [bsz * nnzb_a, bm, bk] stacked packed blocks
    b_blocks: torch.Tensor,  # [bsz * nnzb_b, bk, bn]
    runs: ScheduleRuns,
    *,
    bsz: int,
) -> torch.Tensor:
    """Run the scheduled SpGEMM for ``bsz`` value sets over one schedule.

    Element ``e`` reads A slots ``e*nnzb_a + a_slot`` and B slots
    ``e*nnzb_b + b_slot``. Returns ``[bsz, n_panels, group*bm, bn]``
    float32, each element bitwise-equal to :func:`spgemm_scheduled` on its
    slice.
    """
    _check(a_blocks, b_blocks, runs, bsz)
    if runs.n_panels == 0:
        return _no_panels(a_blocks, b_blocks, runs, (bsz,))
    if a_blocks.device.type == "cpu":
        return ref.spgemm_scheduled_batch_ref(
            a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel,
            runs.sub_row, runs.n_panels, runs.group, bsz,
        )
    out = _launch(a_blocks, b_blocks, runs, bsz)
    spgemm_scheduled_batch.launches += 1
    spgemm_scheduled_batch.bf16_launches += a_blocks.dtype == torch.bfloat16
    spgemm_scheduled_batch.stream_launches[_stream_handle(a_blocks)] += 1
    return out


def compact_row_counts(row_ids: torch.Tensor, *, m: int) -> torch.Tensor:
    """Per-row value counts of C, ``[m]`` int32, from the output map's
    static per-value row ids (CSR order), on their device."""
    return torch.bincount(row_ids, minlength=m).to(torch.int32)


def compact_csr_indptr(row_ids: torch.Tensor, *, m: int) -> torch.Tensor:
    """C's CSR ``indptr``, ``[m + 1]`` int32, on the device of ``row_ids``:
    the row counts and their prefix sum. With the packed values of an
    execute it is a CSR replica of C that never leaves the device."""
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=row_ids.device)
    indptr[1:] = torch.cumsum(compact_row_counts(row_ids, m=m), 0)
    return indptr


spgemm_scheduled.launches = 0
spgemm_scheduled.bf16_launches = 0
spgemm_scheduled.stream_launches = collections.Counter()
spgemm_scheduled_batch.launches = 0
spgemm_scheduled_batch.bf16_launches = 0
spgemm_scheduled_batch.stream_launches = collections.Counter()
