"""Host symbolic phase: the static block schedule of the SpGEMM kernel.

The paper's host program converts A to CSV once (Sec. 4.3); the FPGA kernel
then streams it with data-dependent control flow (FIFOs, RESET tokens).
Here the host additionally runs the *symbolic* half of Gustavson's
algorithm at block granularity: it computes the output block structure and
flattens the whole computation into a static stream of
(a_slot, b_slot, panel, sub_row) matmul triples.

Triple ordering = the paper's schedule, lifted to tiles:

    for each block-row group g (NUM_PE analogue):        # CSV row groups
      for each output block-column j of the group:       # one C panel
        for each inner block k with A(g-rows, k)≠0 ∧ B(k, j)≠0:
          fetch B(k, j) once                             # shared buffer
          for each row r in group with A(r, k)≠0:        # PEs in parallel
            C_panel(g, j)[r] += A(r, k) · B(k, j)

Consecutive triples share ``b_slot`` exactly when the paper's buffering
scheme would share a fetched B row, and every C panel is visited in one
contiguous run.

The GPU kernel gives one thread block to each (panel, sub_row) output tile,
so it reads the schedule regrouped by tile: :func:`panel_runs` returns each
tile's triples, in triple order, as one contiguous run.

The symbolic phase also precomputes C's *output-scatter structure*
(:class:`AssemblyMap`, built by :func:`build_assembly_map`): the CSR pattern
of C at element granularity plus a flat gather map from the kernel's output
panels into packed CSR value order. With it, the numeric phase needs no
data-dependent ``nonzero`` scan — assembly is one static device gather
(Nagasaka et al. 2018: the symbolic phase can precompute all output
accumulation structure, leaving the numeric phase pure
gather-multiply-scatter). :func:`assembly_map_on` computes the same map
with tensor ops on a device, where a CUDA plan builds it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sparse.formats import BCSR, BCSV

__all__ = [
    "AssemblyMap",
    "ScheduleShard",
    "SpGEMMSchedule",
    "assembly_from_arrays",
    "assembly_map_on",
    "assembly_to_arrays",
    "build_assembly_map",
    "build_compact_map",
    "build_exact_schedule",
    "build_spgemm_schedule",
    "exact_assembly_map",
    "panel_runs",
    "partition_spgemm_schedule",
    "schedule_from_arrays",
    "schedule_to_arrays",
    "shard_from_group_range",
    "shards_from_bounds",
    "shards_to_bounds",
    "stack_shard_schedules",
    "structural_product_pattern",
]


@dataclasses.dataclass
class SpGEMMSchedule:
    """Flat static schedule consumed by kernels/gustavson_spgemm.py."""

    # Per-triple arrays, length T.
    a_slot: np.ndarray  # index into packed A blocks [nnzb_a, bm, bk]
    b_slot: np.ndarray  # index into packed B blocks [nnzb_b, bk, bn]
    panel: np.ndarray  # index into output panels [n_panels, G*bm, bn]
    sub_row: np.ndarray  # block-row within the group (0..G-1)
    start: np.ndarray  # 1 iff first triple of its panel
    # Panel -> C-block mapping (host-side scatter after the kernel).
    panel_group: np.ndarray  # [n_panels] block-row group id
    panel_bcol: np.ndarray  # [n_panels] C block-column
    # C block structure (symbolic Gustavson result).
    c_brow: np.ndarray  # [nnzb_c]
    c_bcol: np.ndarray  # [nnzb_c]
    group: int
    grid_m: int  # A block-rows
    grid_n: int  # B block-cols
    grid_k: int

    @property
    def num_triples(self) -> int:
        return int(self.a_slot.shape[0])

    @property
    def n_panels(self) -> int:
        return int(self.panel_group.shape[0])

    @property
    def nnzb_c(self) -> int:
        return int(self.c_brow.shape[0])

    def b_fetches(self) -> int:
        """Number of B-block fetches when a repeated ``b_slot`` is not
        fetched again (the paper's shared B-row buffer)."""
        if self.num_triples == 0:
            return 0
        change = np.empty(self.num_triples, dtype=bool)
        change[0] = True
        change[1:] = self.b_slot[1:] != self.b_slot[:-1]
        return int(change.sum())

    def block_omar(self) -> float:
        """Scheduled-level OMAR: saved B fetches / naive fetches (Eq. 1)."""
        t = self.num_triples
        if t == 0:
            return 0.0
        return 100.0 * (t - self.b_fetches()) / t


def build_spgemm_schedule(a: BCSV, b: BCSR) -> SpGEMMSchedule:
    """Symbolic block-Gustavson: structure of C + the triple schedule.

    At group 1 the schedule is :func:`build_exact_schedule`'s over the block
    patterns, built in vectorized steps (:func:`_group1_schedule`); other
    groups, and block patterns out of canonical order, take the loop below.
    Both give the same arrays bit for bit."""
    bm, bk = a.block_shape
    bk2, bn = b.block_shape
    if bk != bk2:
        raise ValueError(f"block inner dims mismatch: {a.block_shape} vs {b.block_shape}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matrix inner dims mismatch: {a.shape} vs {b.shape}")
    grid_m, grid_k = a.grid
    grid_n = b.grid[1]
    group = a.group
    if group == 1:
        schedule = _group1_schedule(a, b)
        if schedule is not None:
            return schedule

    # Index A blocks by (group, k) -> [(sub_row, slot)...], preserving BCSV
    # (vector-major) order inside each group.
    a_by_group_k: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for slot in range(a.nnzb):
        g = int(a.brow[slot]) // group
        k = int(a.bcol[slot])
        a_by_group_k.setdefault((g, k), []).append((int(a.brow[slot]) - g * group, slot))

    # Index B blocks by (k, j) -> slot.
    b_slot_of: Dict[Tuple[int, int], int] = {}
    for kb in range(b.indptr.shape[0] - 1):
        for s in range(int(b.indptr[kb]), int(b.indptr[kb + 1])):
            b_slot_of[(kb, int(b.indices[s]))] = s

    n_groups = a.n_groups
    a_slots: List[int] = []
    b_slots: List[int] = []
    panels: List[int] = []
    sub_rows: List[int] = []
    starts: List[int] = []
    panel_group: List[int] = []
    panel_bcol: List[int] = []
    c_blocks: set = set()

    for g in range(n_groups):
        # ks present in this group, in ascending k (the CSV vector order).
        ks = sorted({k for (gg, k) in a_by_group_k if gg == g})
        if not ks:
            continue
        # Output block-columns reachable from this group: ∪_k cols(B(k,:)).
        js = sorted(
            {
                int(b.indices[s])
                for k in ks
                for s in range(int(b.indptr[k]), int(b.indptr[k + 1]))
            }
        )
        for j in js:
            first = True
            for k in ks:
                bs = b_slot_of.get((k, j))
                if bs is None:
                    continue
                for sub_row, a_s in a_by_group_k[(g, k)]:
                    a_slots.append(a_s)
                    b_slots.append(bs)
                    panels.append(len(panel_group))
                    sub_rows.append(sub_row)
                    starts.append(1 if first else 0)
                    first = False
                    c_blocks.add((g * group + sub_row, j))
            if not first:  # at least one triple was emitted for this panel
                panel_group.append(g)
                panel_bcol.append(j)

    c_sorted = sorted(c_blocks)
    c_brow = np.asarray([r for r, _ in c_sorted], np.int32)
    c_bcol = np.asarray([c for _, c in c_sorted], np.int32)
    return SpGEMMSchedule(
        a_slot=np.asarray(a_slots, np.int32),
        b_slot=np.asarray(b_slots, np.int32),
        panel=np.asarray(panels, np.int32),
        sub_row=np.asarray(sub_rows, np.int32),
        start=np.asarray(starts, np.int32),
        panel_group=np.asarray(panel_group, np.int32),
        panel_bcol=np.asarray(panel_bcol, np.int32),
        c_brow=c_brow,
        c_bcol=c_bcol,
        group=group,
        grid_m=grid_m,
        grid_n=grid_n,
        grid_k=grid_k,
    )


def _strictly_ascending(major: np.ndarray, minor: np.ndarray, width: int) -> bool:
    key = major.astype(np.int64) * width + minor.astype(np.int64)
    return key.size < 2 or bool((key[1:] > key[:-1]).all())


def _group1_schedule(a: BCSV, b: BCSR) -> Optional[SpGEMMSchedule]:
    """:func:`build_spgemm_schedule` at group 1, in O(triples) vectorized
    steps, or ``None`` where the loop must build it.

    At group 1 a block-row group is one block row, so ``sub_row`` is 0, a
    panel is one C block and the panels ascend in (row, column). BCSV's
    vector-major order is then (brow, bcol) ascending, and the loop emits
    each panel's triples with k ascending: the construction of
    :func:`build_exact_schedule` over the two block patterns, whose A
    positions are A's slots and B positions B's. That holds where A's
    blocks ascend strictly in (brow, bcol) and B's columns strictly within
    each block row (no duplicate block, which the loop resolves on its
    own terms), and where the triples fit the element builder's int32
    slots."""
    grid_k, grid_n = a.grid[1], b.grid[1]
    b_row = np.repeat(np.arange(b.indptr.shape[0] - 1, dtype=np.int64), np.diff(b.indptr))
    if not (_strictly_ascending(a.brow, a.bcol, grid_k)
            and _strictly_ascending(b_row, b.indices, grid_n)):
        return None
    b_len = np.diff(np.asarray(b.indptr, np.int64))
    if int(b_len[np.asarray(a.bcol, np.int64)].sum()) > np.iinfo(np.int32).max:
        return None
    return build_exact_schedule(a.brow, a.bcol, b_row, b.indices, a.grid, (grid_k, grid_n))


def build_exact_schedule(
    a_row: np.ndarray,
    a_col: np.ndarray,
    b_row: np.ndarray,
    b_col: np.ndarray,
    a_shape: Tuple[int, int],
    b_shape: Tuple[int, int],
) -> SpGEMMSchedule:
    """Symbolic Gustavson at element granularity: the schedule that
    :func:`build_spgemm_schedule` builds at tile (1, 1, 1) and group 1,
    from the operands' canonical COO patterns, in O(pairs) vectorized
    steps instead of one Python append per triple.

    At that tile every block is one element: A's slots are its canonical
    COO positions (BCSV's vector-major order at group 1 is row-major), B's
    likewise; a triple is a pair ``A[i,k]·B[k,j]``, a panel is one entry of
    C, and the panels are C's entries in CSR order. Each A entry ``(i, k)``
    is expanded against B's row ``k``, which yields the pairs in ``(i, k)``
    order; a stable sort by ``(i, j)`` then keeps ``k`` ascending inside
    each entry, as the block builder emits them.
    """
    m, k = int(a_shape[0]), int(a_shape[1])
    k2, n = int(b_shape[0]), int(b_shape[1])
    if k != k2:
        raise ValueError(f"matrix inner dims mismatch: {a_shape} vs {b_shape}")
    a_row = np.asarray(a_row, np.int64)
    a_col = np.asarray(a_col, np.int64)
    b_indptr = np.zeros(k + 1, np.int64)
    np.cumsum(np.bincount(np.asarray(b_row, np.int64), minlength=k), out=b_indptr[1:])
    counts = b_indptr[a_col + 1] - b_indptr[a_col]
    pairs = int(counts.sum())
    if pairs > np.iinfo(np.int32).max:
        raise ValueError(f"{pairs} pairs exceed the schedule's int32 slots")
    a_slot = np.repeat(np.arange(a_row.shape[0], dtype=np.int64), counts)
    # B's position of each pair: its row's start plus its place in the row.
    first = np.cumsum(counts) - counts
    b_slot = np.repeat(b_indptr[a_col] - first, counts) + np.arange(pairs, dtype=np.int64)
    del first
    key = a_row[a_slot] * n + np.asarray(b_col, np.int64)[b_slot]
    order = np.argsort(key, kind="stable")
    key = key[order]
    a_slot = a_slot[order].astype(np.int32)
    b_slot = b_slot[order].astype(np.int32)
    del order
    start = np.ones(pairs, np.int32)
    if pairs:
        np.not_equal(key[1:], key[:-1], out=start[1:], casting="unsafe")
    entry = key[start.astype(bool)]
    c_row = (entry // n).astype(np.int32)
    c_col = (entry % n).astype(np.int32)
    return SpGEMMSchedule(
        a_slot=a_slot,
        b_slot=b_slot,
        panel=(np.cumsum(start, dtype=np.int64) - 1).astype(np.int32),
        sub_row=np.zeros(pairs, np.int32),
        start=start,
        panel_group=c_row,
        panel_bcol=c_col,
        c_brow=c_row,
        c_bcol=c_col,
        group=1,
        grid_m=m,
        grid_n=n,
        grid_k=k,
    )


def exact_assembly_map(schedule: SpGEMMSchedule, out_shape: Tuple[int, int]) -> AssemblyMap:
    """The :class:`AssemblyMap` of an element schedule
    (:func:`build_exact_schedule`): the panels are C's entries in CSR
    order, so the gather is the identity. Equal to
    :func:`build_assembly_map` at block shape (1, 1), without its sort."""
    m, n = int(out_shape[0]), int(out_shape[1])
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(schedule.c_brow, minlength=m), out=indptr[1:])
    return AssemblyMap(np.arange(schedule.nnzb_c, dtype=np.int32), indptr,
                       np.asarray(schedule.c_bcol, np.int32), (m, n))


def panel_runs(schedule: SpGEMMSchedule) -> Tuple[np.ndarray, np.ndarray]:
    """The triples of each (panel, sub_row) output tile, as contiguous runs.

    Tile ``i = panel * group + sub_row`` owns the triples
    ``order[ptr[i]:ptr[i + 1]]``, in triple order (a stable regrouping, so
    each tile accumulates its products in the same order as the triple
    stream). A tile without triples has an empty run. Every triple lies
    in exactly one run.

    Returns ``(ptr, order)``: ``ptr`` is ``[n_panels * group + 1]`` int64,
    ``order`` is ``[T]`` int64 triple indices.
    """
    n_tiles = schedule.n_panels * schedule.group
    tile = (schedule.panel.astype(np.int64) * schedule.group
            + schedule.sub_row.astype(np.int64))
    order = np.argsort(tile, kind="stable")
    ptr = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(np.bincount(tile, minlength=n_tiles), out=ptr[1:])
    return ptr, order


@dataclasses.dataclass
class AssemblyMap:
    """C's output-scatter structure, precomputed by the symbolic phase.

    The numeric phase produces panels ``[n_panels, group*bm, bn]``; this map
    turns them into CSR with one static gather —
    ``data = panels.reshape(-1)[gather]`` — so assembly is value-independent
    (no ``nonzero`` scan). The CSR pattern is *structural*:
    every element of every structurally nonzero C block (trimmed to the true
    ``shape``) is stored, including elements that compute to exact zero.
    """

    gather: np.ndarray  # [nnz] flat indices into panels.reshape(-1)
    indptr: np.ndarray  # [m + 1] int64 CSR row pointers
    indices: np.ndarray  # [nnz] int32 CSR column ids
    shape: Tuple[int, int]  # true (untrimmed-by-padding) C shape

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def nbytes(self) -> int:
        return self.gather.nbytes + self.indptr.nbytes + self.indices.nbytes


def _blocks_ascending(c_brow, c_bcol, grid_n: int) -> bool:
    """Whether C's blocks are strictly (brow, bcol)-ascending, as
    :func:`build_spgemm_schedule` emits them."""
    key = np.asarray(c_brow, np.int64) * grid_n + np.asarray(c_bcol, np.int64)
    return key.size < 2 or bool((np.diff(key) > 0).all())


def _assembly_row_major(brow, bcol, base, bm: int, bn: int, m: int, n: int,
                        gdtype) -> AssemblyMap:
    """The assembly map of (brow, bcol)-ascending C blocks, without a sort.

    One output row spans the blocks of its block row, so row-major order
    is a transpose per block row, ``[k, bm, bn] -> [bm, k, bn]`` (``k`` the
    row's block count). It is computed on element-row segments (row ``rr``
    of block ``b`` is ``bn`` elements contiguous in C and in the panel):
    segment ``(b, rr)`` lands at ``first * bm + rr * k + j``, ``first`` the
    block row's first block and ``j`` the block's place in it. ``base`` is
    each block's flat panel offset; overhanging rows and columns are
    dropped."""
    nb = brow.shape[0]
    first = np.searchsorted(brow, brow)
    k = np.searchsorted(brow, brow, side="right") - first
    j = np.arange(nb, dtype=np.int64) - first
    rr = np.arange(bm, dtype=np.int64)
    order = np.empty(nb * bm, np.int64)
    order[((first * bm + j)[:, None] + k[:, None] * rr[None, :]).reshape(-1)] = \
        np.arange(nb * bm, dtype=np.int64)
    blk, srr = np.divmod(order, bm)
    row = brow[blk] * bm + srr
    inside = row < m
    if not inside.all():
        blk, srr, row = blk[inside], srr[inside], row[inside]
    col0 = bcol[blk] * bn
    width = np.clip(n - col0, 0, bn)
    cc = np.arange(bn)
    gather = (base[blk] + srr * bn).astype(gdtype)[:, None] + cc.astype(gdtype)
    cols = col0.astype(np.int32)[:, None] + cc.astype(np.int32)
    if (width < bn).any():
        keep = cc[None, :] < width[:, None]
        gather, cols = gather[keep], cols[keep]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(row, weights=width, minlength=m).astype(np.int64),
              out=indptr[1:])
    return AssemblyMap(gather.reshape(-1), indptr, cols.reshape(-1), (m, n))


def _block_bases(schedule: SpGEMMSchedule, bm: int, bn: int):
    """Each C block's flat offset into the kernel's output panels
    ``[n_panels, group*bm, bn]`` (int64), and the dtype a gather into
    them takes: int32 unless the panels hold more than int32 counts."""
    g = schedule.group
    # Panel of each C block. Panels are emitted in ascending (group, bcol)
    # order by build_spgemm_schedule, so a searchsorted on the combined key
    # recovers the panel id; every C block has a panel by construction.
    pkey = schedule.panel_group.astype(np.int64) * schedule.grid_n \
        + schedule.panel_bcol
    cgrp = schedule.c_brow.astype(np.int64) // g
    ckey = cgrp * schedule.grid_n + schedule.c_bcol
    p_of = np.minimum(np.searchsorted(pkey, ckey), pkey.shape[0] - 1)
    if not np.array_equal(pkey[p_of], ckey):
        raise AssertionError("C block without a matching output panel")
    sub = schedule.c_brow.astype(np.int64) - cgrp * g
    flat_panels = schedule.n_panels * g * bm * bn
    gdtype = np.int32 if flat_panels <= np.iinfo(np.int32).max else np.int64
    return p_of * (g * bm * bn) + sub * (bm * bn), gdtype


def build_assembly_map(
    schedule: SpGEMMSchedule,
    block_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
) -> AssemblyMap:
    """Map kernel output panels to C's CSR, symbolically.

    ``block_shape`` is C's block shape ``(bm, bn)``; ``out_shape`` the true
    ``(m, n)`` (block grids are ceil-padded, so edge blocks may overhang —
    overhanging elements are structurally zero and dropped here, at plan
    time).
    """
    bm, bn = block_shape
    m, n = out_shape
    nb = schedule.nnzb_c
    if nb == 0 or bm == 0 or bn == 0:
        return AssemblyMap(
            np.zeros(0, np.int32), np.zeros(m + 1, np.int64),
            np.zeros(0, np.int32), (m, n),
        )
    base, gdtype = _block_bases(schedule, bm, bn)
    # CSR order: row-major. The schedule emits C's blocks ascending, which
    # needs no sort; any other order takes the reference's sort below.
    if _blocks_ascending(schedule.c_brow, schedule.c_bcol, schedule.grid_n):
        return _assembly_row_major(
            schedule.c_brow.astype(np.int64), schedule.c_bcol.astype(np.int64),
            base, bm, bn, m, n, gdtype)
    # Per-block element coordinates and their flat panel offsets.
    rr = np.arange(bm, dtype=np.int64)[None, :, None]  # [1, bm, 1]
    cc = np.arange(bn, dtype=np.int64)[None, None, :]  # [1, 1, bn]
    rows = schedule.c_brow.astype(np.int64)[:, None, None] * bm + rr
    cols = schedule.c_bcol.astype(np.int64)[:, None, None] * bn + cc
    gather = base[:, None, None] + rr * bn + cc
    shape3 = (nb, bm, bn)
    rows = np.broadcast_to(rows, shape3).reshape(-1)
    cols = np.broadcast_to(cols, shape3).reshape(-1)
    gather = gather.reshape(-1)
    keep = (rows < m) & (cols < n)
    if not keep.all():
        rows, cols, gather = rows[keep], cols[keep], gather[keep]
    # CSR order: row-major. Within one block-row, blocks are already
    # bcol-ascending, but one output row spans several blocks, so sort.
    order = np.lexsort((cols, rows))
    rows, cols, gather = rows[order], cols[order], gather[order]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    return AssemblyMap(
        gather.astype(gdtype, copy=False), indptr,
        cols.astype(np.int32), (m, n),
    )


def assembly_map_on(
    device,
    schedule: SpGEMMSchedule,
    block_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
) -> AssemblyMap:
    """:func:`build_assembly_map` computed with tensor ops on ``device``:
    the same map, bitwise, its three arrays tensors there (``gather`` in
    ``build_assembly_map``'s dtype, ``indptr`` int64, ``indices`` int32).

    C's blocks must be (brow, bcol)-ascending, as
    :func:`build_spgemm_schedule` emits them. Only the blocks' coordinates,
    widths and panel offsets go to the device; the arithmetic is
    :func:`_assembly_row_major`'s, on element-row segments in CSR order.
    A segment of an overhanging row gets width 0, so no step compacts a
    mask: segment ``s`` covers CSR positions ``[start_s, start_s + w_s)``,
    and position ``p`` of it gathers ``gbase_s + p - start_s`` and has
    column ``col0_s + p - start_s``. Nothing waits for the device.
    """
    bm, bn = block_shape
    m, n = out_shape
    dev = torch.device(device)
    if schedule.nnzb_c == 0 or bm == 0 or bn == 0:
        empty = build_assembly_map(schedule, block_shape, out_shape)
        return AssemblyMap(*(torch.from_numpy(x).to(dev) for x in (
            empty.gather, empty.indptr, empty.indices)), (m, n))
    if not _blocks_ascending(schedule.c_brow, schedule.c_bcol, schedule.grid_n):
        raise ValueError("assembly_map_on needs C's blocks (brow, bcol)-ascending")
    base, gdtype = _block_bases(schedule, bm, bn)
    brow = schedule.c_brow.astype(np.int64)
    bcol = schedule.c_bcol.astype(np.int64)
    width = np.clip(n - bcol * bn, 0, bn)
    # The map's size, from the blocks alone: the device's result needs no
    # read-back to be sized.
    nnz = int((np.clip(m - brow * bm, 0, bm) * width).sum())
    brow_t, bcol_t, base_t, width_t = torch.from_numpy(
        np.stack([brow, bcol, base, width])).to(dev)
    nb = brow.shape[0]
    # Segment (b, rr) lands at first * bm + rr * k + j (_assembly_row_major).
    first = torch.searchsorted(brow_t, brow_t)
    k = torch.searchsorted(brow_t, brow_t, right=True) - first
    j = torch.arange(nb, device=dev) - first
    rr = torch.arange(bm, device=dev)
    dest = ((first * bm + j)[:, None] + k[:, None] * rr[None, :]).reshape(-1)
    order = torch.empty(nb * bm, dtype=torch.int64, device=dev)
    order[dest] = torch.arange(nb * bm, device=dev)
    blk, srr = order // bm, order % bm
    row = brow_t[blk] * bm + srr
    seg_w = torch.where(row < m, width_t[blk], 0)
    end = torch.cumsum(seg_w, 0)
    start = end - seg_w
    # Rows ascend over the segments: a row's pointer is the width of the
    # segments above it.
    indptr = torch.cat([end.new_zeros(1), end])[
        torch.searchsorted(row, torch.arange(m + 1, device=dev))]
    # Element level, in the gather's dtype (int64 only where the panels
    # outgrow int32; then nnz may too).
    wdt = torch.int32 if gdtype == np.int32 else torch.int64
    seg = torch.repeat_interleave(seg_w.to(wdt), output_size=nnz)
    pos = torch.arange(nnz, dtype=wdt, device=dev)
    gather = (base_t[blk] + srr * bn - start).to(wdt).index_select(0, seg).add_(pos)
    cols = (bcol_t[blk] * bn - start).to(wdt).index_select(0, seg).add_(pos)
    return AssemblyMap(gather, indptr, cols.to(torch.int32), (m, n))


def structural_product_pattern(
    a_row: np.ndarray,
    a_col: np.ndarray,
    b_row: np.ndarray,
    b_col: np.ndarray,
    a_shape: Tuple[int, int],
    b_shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Element-exact structural pattern of ``C = A @ B``.

    Pure symbolic Gustavson at element granularity: position ``(i, j)`` is
    in the result iff some ``k`` has ``A[i, k]`` and ``B[k, j]`` both
    structurally nonzero. Value-independent by construction — numeric
    cancellation keeps its (explicitly stored) slot, exactly like the
    block-structural pattern, just without block fill.

    Inputs are the operands' COO patterns in canonical row-major order
    (``B``'s row groups must be contiguous; ``sum_duplicates`` output
    qualifies). Returns ``(rows, cols)`` sorted strictly row-major —
    ``rows`` as int64, ``cols`` as int32 — ready for
    :func:`build_compact_map`.
    """
    m, k = int(a_shape[0]), int(a_shape[1])
    k2, n = int(b_shape[0]), int(b_shape[1])
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a_shape} x {b_shape}")
    a_row = np.asarray(a_row, np.int64)
    a_col = np.asarray(a_col, np.int64)
    b_col64 = np.asarray(b_col, np.int64)
    b_indptr = np.zeros(k + 1, np.int64)
    np.cumsum(np.bincount(np.asarray(b_row, np.int64), minlength=k),
              out=b_indptr[1:])
    counts = b_indptr[a_col + 1] - b_indptr[a_col]
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    # Expand every (i, k) against B's row k: the standard repeat/offset
    # expansion (one flat arange minus per-segment restart offsets).
    out_rows = np.repeat(a_row, counts)
    cum = np.cumsum(counts)
    offset = np.arange(total, dtype=np.int64) - np.repeat(cum - counts, counts)
    out_cols = b_col64[np.repeat(b_indptr[a_col], counts) + offset]
    key = np.unique(out_rows * n + out_cols)
    return key // n, (key % n).astype(np.int32)


def build_compact_map(
    assembly: AssemblyMap,
    rows: np.ndarray,
    cols: np.ndarray,
) -> AssemblyMap:
    """Element-exact (compacted) sibling of :func:`build_assembly_map`.

    ``assembly`` is the structural *block* map for the same schedule;
    ``(rows, cols)`` is C's element-exact pattern in strictly ascending
    row-major order (e.g. from :func:`structural_product_pattern`). Every
    compact position must exist in the block pattern — the compact map is
    a subset selection: its gather indices are the block map's gather at
    the surviving positions, so executing through it *is* the fused
    compaction (one static gather, no ``nonzero`` scan), and the
    exactly-once/pad-panel proofs inherit directly from the block map.

    Returns an :class:`AssemblyMap` whose CSR stores only the element-
    structural nonzeros (explicit zero *blocks'* fill is dropped; numeric
    cancellation within a structural element is kept).
    """
    m, n = assembly.shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(
            f"pattern arrays must be equal-length vectors, got "
            f"{rows.shape} / {cols.shape}"
        )
    nnz = int(rows.shape[0])
    indptr = np.zeros(m + 1, np.int64)
    if nnz == 0:
        return AssemblyMap(
            np.zeros(0, assembly.gather.dtype), indptr,
            np.zeros(0, np.int32), (m, n),
        )
    if (rows < 0).any() or (rows >= m).any() or (cols < 0).any() \
            or (cols >= n).any():
        raise ValueError(f"compact pattern indices outside {m}x{n}")
    key = rows * n + cols
    if (np.diff(key) <= 0).any():
        raise ValueError(
            "compact pattern must be strictly ascending row-major "
            "(canonical CSR order)"
        )
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    # Subset selection by searchsorted on the block map's (row, col) keys
    # — strictly ascending by build_assembly_map's lexsort, so equality at
    # the insertion point is exact membership.
    bkey = (
        np.repeat(np.arange(m, dtype=np.int64), np.diff(assembly.indptr))
        * n + assembly.indices.astype(np.int64)
    )
    pos = np.searchsorted(bkey, key)
    ok = pos < bkey.shape[0]
    if not ok.all() or not np.array_equal(bkey[np.minimum(
            pos, max(bkey.shape[0] - 1, 0))], key):
        raise ValueError(
            "compact pattern is not a subset of the structural block "
            "pattern: some element has no kernel output slot"
        )
    return AssemblyMap(
        assembly.gather[pos], indptr, cols.astype(np.int32), (m, n),
    )


# ---------------------------------------------------------------------------
# Flat-array codecs (plan persistence)
#
# A persisted plan is nothing but named numpy arrays plus a JSON header, so
# every symbolic-phase artifact needs a lossless flat-array form. Codecs are
# *bitwise* round-trips: dtypes and shapes are preserved exactly, which is
# what lets a rehydrated plan produce bit-identical results to a cold-built
# one. The array names match the JAX package's, so a plan persisted there
# rehydrates here (``SpGEMMPlan.from_artifacts``).
# ---------------------------------------------------------------------------

_SCHEDULE_ARRAY_FIELDS = (
    "a_slot", "b_slot", "panel", "sub_row", "start",
    "panel_group", "panel_bcol", "c_brow", "c_bcol",
)
_SCHEDULE_DIM_FIELDS = ("group", "grid_m", "grid_n", "grid_k")


def schedule_to_arrays(
    schedule: SpGEMMSchedule, prefix: str = "sched."
) -> Dict[str, np.ndarray]:
    """:class:`SpGEMMSchedule` -> flat ``{name: ndarray}`` dict."""
    out = {prefix + f: getattr(schedule, f) for f in _SCHEDULE_ARRAY_FIELDS}
    out[prefix + "dims"] = np.asarray(
        [getattr(schedule, f) for f in _SCHEDULE_DIM_FIELDS], np.int64
    )
    return out


def schedule_from_arrays(
    arrays: Dict[str, np.ndarray], prefix: str = "sched."
) -> SpGEMMSchedule:
    """Inverse of :func:`schedule_to_arrays` (bitwise round-trip)."""
    dims = np.asarray(arrays[prefix + "dims"])
    if dims.shape != (len(_SCHEDULE_DIM_FIELDS),):
        raise ValueError(f"bad schedule dims: shape {dims.shape}")
    kwargs = {
        f: np.asarray(arrays[prefix + f]) for f in _SCHEDULE_ARRAY_FIELDS
    }
    kwargs.update(zip(_SCHEDULE_DIM_FIELDS, (int(d) for d in dims)))
    return SpGEMMSchedule(**kwargs)


def assembly_to_arrays(
    assembly: AssemblyMap, prefix: str = "asm."
) -> Dict[str, np.ndarray]:
    """:class:`AssemblyMap` -> flat ``{name: ndarray}`` dict."""
    return {
        prefix + "gather": assembly.gather,
        prefix + "indptr": assembly.indptr,
        prefix + "indices": assembly.indices,
        prefix + "shape": np.asarray(assembly.shape, np.int64),
    }


def assembly_from_arrays(
    arrays: Dict[str, np.ndarray], prefix: str = "asm."
) -> AssemblyMap:
    """Inverse of :func:`assembly_to_arrays` (bitwise round-trip)."""
    shape = np.asarray(arrays[prefix + "shape"])
    if shape.shape != (2,):
        raise ValueError(f"bad assembly shape: {shape!r}")
    return AssemblyMap(
        np.asarray(arrays[prefix + "gather"]),
        np.asarray(arrays[prefix + "indptr"]),
        np.asarray(arrays[prefix + "indices"]),
        (int(shape[0]), int(shape[1])),
    )


@dataclasses.dataclass
class ScheduleShard:
    """One device's slice of a partitioned :class:`SpGEMMSchedule`.

    ``schedule`` is a fully self-contained shard-local schedule: its panel
    ids, block-row groups, C block-rows, and A slots are all rebased to the
    shard, so it can be executed (and its :class:`AssemblyMap` built)
    exactly like an unsharded schedule. The ``*_lo``/``*_hi`` ranges map
    shard-local objects back to the parent schedule's coordinates — they
    are contiguous by construction, which is what makes the final C a
    single concatenation of per-shard CSR segments.
    """

    schedule: SpGEMMSchedule  # shard-local ids throughout
    group_lo: int  # [group_lo, group_hi) parent block-row groups
    group_hi: int
    triple_lo: int  # [triple_lo, triple_hi) parent triples
    triple_hi: int
    panel_lo: int  # [panel_lo, panel_hi) parent panels
    panel_hi: int
    a_lo: int  # [a_lo, a_hi) parent packed-A slots
    a_hi: int

    @property
    def num_triples(self) -> int:
        return self.triple_hi - self.triple_lo

    @property
    def n_panels(self) -> int:
        return self.panel_hi - self.panel_lo


def _balanced_boundaries(counts: np.ndarray, n_parts: int) -> np.ndarray:
    """Contiguous partition of ``counts`` into ``n_parts`` segments
    minimizing the max segment sum (binary search on capacity + greedy
    fill). Returns ``n_parts + 1`` boundaries; trailing segments may be
    empty when there are fewer nonempty groups than parts."""
    counts = np.asarray(counts, np.int64)
    n = counts.shape[0]
    if n == 0 or n_parts <= 1:
        return np.concatenate(
            [np.zeros(1, np.int64), np.full(n_parts, n, np.int64)]
        )
    prefix = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    total = int(prefix[-1])

    def parts_needed(cap: int) -> int:
        """Greedy: number of <=cap segments required (inf if impossible)."""
        used, start = 0, 0
        while start < n:
            # Largest end with sum(start..end) <= cap.
            end = int(np.searchsorted(prefix, prefix[start] + cap, "right")) - 1
            if end <= start:  # single group exceeds cap
                return n_parts + 1
            used += 1
            start = end
        return used

    lo = max(int(counts.max(initial=0)), -(-total // n_parts))
    hi = max(total, lo)
    while lo < hi:
        mid = (lo + hi) // 2
        if parts_needed(mid) <= n_parts:
            hi = mid
        else:
            lo = mid + 1
    cap = lo
    # Greedy fill at the optimal cap. cap >= counts.max() guarantees each
    # segment advances, and cap feasibility guarantees <= n_parts segments
    # cover everything; exhausted trailing parts stay empty (ragged /
    # over-provisioned meshes).
    bounds = [0]
    start = 0
    for _ in range(n_parts):
        end = int(np.searchsorted(prefix, prefix[start] + cap, "right")) - 1
        bounds.append(end)
        start = end
    assert bounds[-1] == n, "balanced partition failed to cover all groups"
    return np.asarray(bounds, np.int64)


def partition_spgemm_schedule(
    schedule: SpGEMMSchedule, n_shards: int
) -> List[ScheduleShard]:
    """Split one schedule into ``n_shards`` shard-local schedules.

    The cut points are block-row *group* boundaries (a group's output rows
    live in exactly one shard, so C is a concatenation of per-shard row
    ranges), chosen to balance **triple count** — the numeric-phase work
    unit — not panel count. Because ``build_spgemm_schedule`` emits triples,
    panels, A slots (BCSV is group-major), and C blocks all in ascending
    group order, every shard is a contiguous slice of each parent array;
    the slices are rebased so each shard's schedule stands alone.

    Shards may be empty (``n_shards`` > nonempty groups): they get
    zero-length schedules and contribute nothing to C.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    g = schedule.group
    n_groups = -(-schedule.grid_m // g) if schedule.grid_m else 0
    # Per-triple parent group id; triples are emitted group-ascending.
    g_of_t = schedule.panel_group[schedule.panel]
    counts = np.bincount(g_of_t, minlength=max(n_groups, 1))[:max(n_groups, 1)]
    bounds = _balanced_boundaries(counts, n_shards)
    return shards_from_bounds(schedule, bounds)


def shard_from_group_range(
    schedule: SpGEMMSchedule, g_lo: int, g_hi: int
) -> ScheduleShard:
    """The shard owning parent block-row groups ``[g_lo, g_hi)``.

    Everything beyond the group range is *derived* from the parent schedule
    (triple/panel/C-block spans by searchsorted on the group-ascending
    parent arrays, the A-slot span from the triples themselves), which is
    what makes the group boundaries alone a complete serialization of a
    partition: :func:`shards_from_bounds` rebuilds bitwise-identical
    shards from an ``[n_shards + 1]`` bounds vector.
    """
    g = schedule.group
    g_lo, g_hi = int(g_lo), int(g_hi)
    g_of_t = schedule.panel_group[schedule.panel]
    t_lo, t_hi = np.searchsorted(g_of_t, [g_lo, g_hi])
    p_lo, p_hi = np.searchsorted(schedule.panel_group, [g_lo, g_hi])
    c_lo, c_hi = np.searchsorted(schedule.c_brow, [g_lo * g, g_hi * g])
    t_lo, t_hi, p_lo, p_hi, c_lo, c_hi = map(
        int, (t_lo, t_hi, p_lo, p_hi, c_lo, c_hi))
    if t_hi > t_lo:
        # BCSV packs blocks group-major, so the slots this shard's
        # triples touch form a contiguous parent range.
        a_lo = int(schedule.a_slot[t_lo:t_hi].min())
        a_hi = int(schedule.a_slot[t_lo:t_hi].max()) + 1
    else:
        a_lo = a_hi = 0
    grid_m_local = max(0, min(schedule.grid_m, g_hi * g) - g_lo * g)
    local = SpGEMMSchedule(
        a_slot=schedule.a_slot[t_lo:t_hi] - a_lo,
        b_slot=schedule.b_slot[t_lo:t_hi].copy(),
        panel=schedule.panel[t_lo:t_hi] - p_lo,
        sub_row=schedule.sub_row[t_lo:t_hi].copy(),
        start=schedule.start[t_lo:t_hi].copy(),
        panel_group=schedule.panel_group[p_lo:p_hi] - g_lo,
        panel_bcol=schedule.panel_bcol[p_lo:p_hi].copy(),
        c_brow=schedule.c_brow[c_lo:c_hi] - g_lo * g,
        c_bcol=schedule.c_bcol[c_lo:c_hi].copy(),
        group=g,
        grid_m=grid_m_local,
        grid_n=schedule.grid_n,
        grid_k=schedule.grid_k,
    )
    return ScheduleShard(
        schedule=local,
        group_lo=g_lo, group_hi=g_hi,
        triple_lo=t_lo, triple_hi=t_hi,
        panel_lo=p_lo, panel_hi=p_hi,
        a_lo=a_lo, a_hi=a_hi,
    )


def shards_to_bounds(shards: List[ScheduleShard]) -> np.ndarray:
    """Partition -> its ``[n_shards + 1]`` group-boundary vector (the
    shards' flat-array serialization; see :func:`shard_from_group_range`)."""
    if not shards:
        return np.zeros(1, np.int64)
    return np.asarray(
        [shards[0].group_lo] + [s.group_hi for s in shards], np.int64
    )


def shards_from_bounds(
    schedule: SpGEMMSchedule, bounds: np.ndarray
) -> List[ScheduleShard]:
    """Rebuild a partition from its group-boundary vector.

    Boundaries must be non-decreasing and cover all groups; anything else
    (a stale or foreign persistence payload) raises rather than silently
    mis-slicing."""
    bounds = np.asarray(bounds, np.int64)
    if bounds.ndim != 1 or bounds.shape[0] < 2:
        raise ValueError(f"bad shard bounds: {bounds!r}")
    if (np.diff(bounds) < 0).any() or int(bounds[0]) != 0:
        raise ValueError(f"shard bounds not a partition: {bounds!r}")
    n_groups = -(-schedule.grid_m // schedule.group) if schedule.grid_m else 0
    if schedule.num_triples and int(bounds[-1]) < n_groups:
        raise ValueError(
            f"shard bounds cover {int(bounds[-1])} of {n_groups} groups"
        )
    return [
        shard_from_group_range(schedule, bounds[i], bounds[i + 1])
        for i in range(bounds.shape[0] - 1)
    ]


def stack_shard_schedules(
    shards: Sequence[ScheduleShard], t_max: int, p_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-shard triple schedules into padded ``[n_shards, t_max]``
    arrays: the JAX package's sharded executor layout, one program over
    every shard.

    Returns ``(a_slot, b_slot, panel, sub_row, start)``. Padding triples
    execute a real (block 0) x (block 0) matmul into the dummy panel
    ``p_max`` — which no assembly gather reads — with ``start = 1`` so each
    pad zeroes the dummy accumulator before writing (the same dummy-panel
    convention as
    :func:`repro_torch.kernels.gustavson_spgemm.pad_schedule_arrays`,
    applied per shard). The port's sharded executor needs no padding: it
    launches the kernel once per non-empty shard on that shard's own
    schedule, whose per-tile runs the kernel's grid reads.
    """
    s = len(shards)
    a_slot = np.zeros((s, t_max), np.int32)
    b_slot = np.zeros((s, t_max), np.int32)
    panel = np.full((s, t_max), p_max, np.int32)
    sub_row = np.zeros((s, t_max), np.int32)
    start = np.ones((s, t_max), np.int32)
    for i, sh in enumerate(shards):
        t = sh.num_triples
        a_slot[i, :t] = sh.schedule.a_slot
        b_slot[i, :t] = sh.schedule.b_slot
        panel[i, :t] = sh.schedule.panel
        sub_row[i, :t] = sh.schedule.sub_row
        start[i, :t] = sh.schedule.start
    return a_slot, b_slot, panel, sub_row, start
