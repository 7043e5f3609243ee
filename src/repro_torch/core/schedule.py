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
gather-multiply-scatter).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.sparse.formats import BCSR, BCSV

__all__ = [
    "AssemblyMap",
    "SpGEMMSchedule",
    "assembly_from_arrays",
    "assembly_to_arrays",
    "build_assembly_map",
    "build_spgemm_schedule",
    "panel_runs",
    "schedule_from_arrays",
    "schedule_to_arrays",
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
    """Symbolic block-Gustavson: structure of C + the triple schedule."""
    bm, bk = a.block_shape
    bk2, bn = b.block_shape
    if bk != bk2:
        raise ValueError(f"block inner dims mismatch: {a.block_shape} vs {b.block_shape}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matrix inner dims mismatch: {a.shape} vs {b.shape}")
    grid_m, grid_k = a.grid
    grid_n = b.grid[1]
    group = a.group

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
    # Per-block element coordinates and their flat panel offsets.
    rr = np.arange(bm, dtype=np.int64)[None, :, None]  # [1, bm, 1]
    cc = np.arange(bn, dtype=np.int64)[None, None, :]  # [1, 1, bn]
    rows = schedule.c_brow.astype(np.int64)[:, None, None] * bm + rr
    cols = schedule.c_bcol.astype(np.int64)[:, None, None] * bn + cc
    gather = (
        p_of[:, None, None] * (g * bm * bn)
        + (sub[:, None, None] * bm + rr) * bn
        + cc
    )
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
    flat_panels = schedule.n_panels * g * bm * bn
    gdtype = np.int32 if flat_panels <= np.iinfo(np.int32).max else np.int64
    return AssemblyMap(
        gather.astype(gdtype, copy=False), indptr,
        cols.astype(np.int32), (m, n),
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
