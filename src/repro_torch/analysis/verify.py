"""Static plan/schedule verifier: prove plan invariants without executing.

:func:`verify_plan` takes a built :class:`~repro_torch.spgemm.plan.SpGEMMPlan`
(or :class:`~repro_torch.spgemm.plan.ShardedSpGEMMPlan`) and checks, on the
host with numpy only, the invariants the JAX package's verifier checks,
under the same check names:

1. **Schedule well-formedness** — every triple's slot/panel/sub-row index
   in bounds, start flags exactly marking the first triple of each panel,
   every panel visited in one contiguous run, panel and C-block key arrays
   in the ascending order ``build_assembly_map`` requires.
2. **Dummy-pad-panel discipline** — the pad panel of the padded triple
   arrays (``n_panels`` in the single stream, per-element slot
   ``b * (n_panels + 1) + n_panels`` in the batch-folded stream, ``p_max``
   in the stacked shard schedules) is *write-only*: no assembly gather
   index ever reads it.
3. **Assembly coverage** — C's structural CSR is exact: indptr monotone
   and consistent, column indices in range and strictly ascending per
   row, every gather index in range and used **exactly once**, and the
   total nnz equal to the schedule's structural block pattern trimmed to
   the true output shape.
4. **Write-write race freedom** — over the padded triple arrays exactly as
   the JAX package states it (distinct batch elements write disjoint
   ``n_panels + 1``-strided slot ranges; one slot's writers are one
   contiguous run), and over the launch the CUDA kernel really makes
   (:func:`check_schedule_runs`). K1/K2 run one thread block per output
   tile, ``grid = (n_panels * group, bsz)``, and block ``(i, e)`` reads run
   ``ptr[i]:ptr[i+1]`` of the
   :class:`~repro_torch.kernels.gustavson_spgemm.ScheduleRuns` and writes
   rows ``[(e * n_tiles + i) * bm, + bm)`` of the output. The proof
   obligation: ``ptr`` is monotone from 0 to T, every run entry belongs to
   the tile that owns the run (so each run belongs to exactly one tile),
   the runs hold exactly the schedule's triples in triple order, and no
   two (tile, batch) blocks write the same output rows. It is proved over
   the runs the plan's executor staged on its device (per shard for
   sharded plans), or over the host regrouping when the plan has no
   executor.
5. **Shard-partition exactness** (sharded plans) — shard group ranges are
   disjoint, contiguous, and cover all groups; triple/panel/A-slot spans
   tile the parent schedule; and re-deriving every shard from the bounds
   vector (:func:`~repro_torch.core.schedule.shards_from_bounds`)
   reproduces the plan's shards **bitwise**, including each shard's
   rebased local schedule and its per-shard assembly slice.
6. **Compact-output exactness** (``output="compact"`` plans) — the
   compacted gather map is a well-formed canonical CSR, a *subset* of the
   block assembly's gather space with every slot read at most once, and
   bitwise re-derivable from the block assembly and the compact pattern
   via :func:`~repro_torch.core.schedule.build_compact_map`.

Plans also surface configuration-provenance warnings here: a persisted
tuned config whose (tile, group) no longer matches the plan
(``apply_tuned_config`` recorded it in ``plan._stale_tuned`` and ran on
defaults) is reported as a ``tuned.stale-config`` warning.

Everything here is value-independent; a verified plan can still compute
wrong numbers only if the kernels themselves are wrong, which is what the
kernels' checks against their plain versions cover (and
:mod:`repro_torch.analysis.kernel_lint` lints their launches).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.schedule import (
    AssemblyMap,
    SpGEMMSchedule,
    build_assembly_map,
    build_compact_map,
    shards_from_bounds,
    shards_to_bounds,
    stack_shard_schedules,
)
from repro_torch.kernels.gustavson_spgemm import ScheduleRuns, pad_schedule_arrays, stage_runs

__all__ = [
    "Finding",
    "PlanVerificationError",
    "VerifyReport",
    "check_assembly",
    "check_batch_races",
    "check_compact",
    "check_schedule",
    "check_schedule_runs",
    "check_shard_partition",
    "check_stacked_shards",
    "verify_plan",
]


@dataclasses.dataclass
class Finding:
    """One verifier finding. ``check`` is a dotted id (e.g.
    ``"schedule.panel-bounds"``); ``severity`` is ``"error"`` (invariant
    violated) or ``"warning"`` (suspicious but not provably wrong)."""

    check: str
    severity: str
    message: str

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"[{self.severity}] {self.check}: {self.message}"


@dataclasses.dataclass
class VerifyReport:
    """The result of one :func:`verify_plan` pass."""

    plan_kind: str  # "element" | "block"
    sharded: bool
    backend: str
    checks_run: List[str]
    findings: List[Finding]
    elapsed_s: float = 0.0
    # Seconds spent in each check family (``checks_run`` names; the race
    # families include reading back the staged runs).
    check_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def raise_if_failed(self) -> "VerifyReport":
        if not self.ok:
            raise PlanVerificationError(self)
        return self

    def summary(self) -> str:
        status = "ok" if self.ok else f"FAILED ({len(self.errors)} error(s))"
        lines = [
            f"verify_plan: {status} — {len(self.checks_run)} checks, "
            f"{self.elapsed_s * 1e3:.1f} ms "
            f"[{self.plan_kind}{', sharded' if self.sharded else ''}, "
            f"{self.backend}]"
        ]
        lines.extend(f"  {f}" for f in self.findings)
        return "\n".join(lines)


class PlanVerificationError(AssertionError):
    """A plan failed static verification. Carries the full report."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(report.summary())


def _err(findings: List[Finding], check: str, message: str) -> None:
    findings.append(Finding(check=check, severity="error", message=message))


def _bounds_check(
    findings: List[Finding], check: str, arr: np.ndarray, lo: int, hi: int,
    what: str,
) -> None:
    """Assert ``lo <= arr < hi`` elementwise, reporting the first offender."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return
    bad = (arr < lo) | (arr >= hi)
    if bad.any():
        i = int(np.argmax(bad))
        _err(findings, check,
             f"{what}[{i}] = {int(arr.flat[i])} outside [{lo}, {hi})")


# ---------------------------------------------------------------------------
# Check families. Each takes the symbolic artifacts (the launch check also
# the runs a plan staged, copied to the host) and appends findings.
# ---------------------------------------------------------------------------


def _check_column_order(
    findings: List[Finding], check: str, indptr: np.ndarray, indices: np.ndarray,
    n: int,
) -> None:
    """Columns strictly ascending within each row of a CSR whose
    ``indptr`` is well-formed: the key ``row * (n + 1) + column`` rises
    strictly. Its steps are the column steps, plus ``(row gap) * (n + 1)``
    where a row's entries begin; the first offender is reported."""
    step = np.diff(indices.astype(np.int64))
    filled = np.flatnonzero(np.diff(indptr))
    step[indptr[filled[1:]] - 1] += np.diff(filled) * (int(n) + 1)
    bad = step <= 0
    if bad.any():
        i = int(np.argmax(bad))
        row = int(np.searchsorted(indptr, i, side="right")) - 1
        _err(findings, check,
             f"columns not strictly ascending within row {row} (nnz position {i})")


def check_schedule(
    schedule: SpGEMMSchedule,
    nnzb_a: int,
    nnzb_b: int,
    findings: List[Finding],
    label: str = "schedule",
) -> None:
    """Family 1: triple-schedule well-formedness."""
    t = schedule.num_triples
    arrays = {
        "a_slot": schedule.a_slot, "b_slot": schedule.b_slot,
        "panel": schedule.panel, "sub_row": schedule.sub_row,
        "start": schedule.start,
    }
    for name, arr in arrays.items():
        if np.asarray(arr).shape != (t,):
            _err(findings, f"{label}.lengths",
                 f"{name} has shape {np.asarray(arr).shape}, expected ({t},)")
            return  # everything downstream indexes by t
    n_panels = schedule.n_panels
    _bounds_check(findings, f"{label}.a-slot-bounds", schedule.a_slot,
                  0, max(nnzb_a, 1), "a_slot")
    _bounds_check(findings, f"{label}.b-slot-bounds", schedule.b_slot,
                  0, max(nnzb_b, 1), "b_slot")
    _bounds_check(findings, f"{label}.panel-bounds", schedule.panel,
                  0, max(n_panels, 1), "panel")
    _bounds_check(findings, f"{label}.sub-row-bounds", schedule.sub_row,
                  0, max(schedule.group, 1), "sub_row")
    start = np.asarray(schedule.start)
    if start.size and not np.isin(start, (0, 1)).all():
        _err(findings, f"{label}.start-domain",
             "start flags must be 0 or 1")
    if t:
        panel = np.asarray(schedule.panel)
        # Contiguous panel runs: each panel id appears in exactly one run
        # (the JAX package's kernel revisits the panel accumulator across
        # one run of grid steps and writes it back exactly once).
        run_first = np.empty(t, dtype=bool)
        run_first[0] = True
        run_first[1:] = panel[1:] != panel[:-1]
        run_panels = panel[run_first]
        uniq, counts = np.unique(run_panels, return_counts=True)
        if (counts > 1).any():
            p = int(uniq[np.argmax(counts > 1)])
            _err(findings, f"{label}.panel-contiguity",
                 f"panel {p} is visited in {int(counts.max())} separate "
                 f"runs; each output panel must be one contiguous run")
        elif uniq.shape[0] != n_panels:
            _err(findings, f"{label}.panel-coverage",
                 f"{uniq.shape[0]} of {n_panels} panels receive triples; "
                 f"build_spgemm_schedule never emits empty panels")
        # start == 1 exactly on the first triple of each panel run.
        if not np.array_equal(start.astype(bool), run_first):
            i = int(np.argmax(start.astype(bool) != run_first))
            _err(findings, f"{label}.start-flags",
                 f"start[{i}] = {int(start[i])} but triple {i} is "
                 f"{'the first' if run_first[i] else 'not the first'} of "
                 f"its panel run")
    # Panel keys ascending (the searchsorted precondition in
    # build_assembly_map) and in range.
    _bounds_check(findings, f"{label}.panel-group-bounds",
                  schedule.panel_group, 0,
                  max(-(-schedule.grid_m // max(schedule.group, 1)), 1),
                  "panel_group")
    _bounds_check(findings, f"{label}.panel-bcol-bounds",
                  schedule.panel_bcol, 0, max(schedule.grid_n, 1),
                  "panel_bcol")
    pkey = (schedule.panel_group.astype(np.int64) * schedule.grid_n
            + schedule.panel_bcol)
    if pkey.size and (np.diff(pkey) <= 0).any():
        _err(findings, f"{label}.panel-order",
             "panel (group, bcol) keys are not strictly ascending")
    # C block pattern sorted and in range.
    _bounds_check(findings, f"{label}.c-brow-bounds", schedule.c_brow,
                  0, max(schedule.grid_m, 1), "c_brow")
    _bounds_check(findings, f"{label}.c-bcol-bounds", schedule.c_bcol,
                  0, max(schedule.grid_n, 1), "c_bcol")
    ckey = (schedule.c_brow.astype(np.int64) * schedule.grid_n
            + schedule.c_bcol)
    if ckey.size and (np.diff(ckey) <= 0).any():
        _err(findings, f"{label}.c-block-order",
             "C block (brow, bcol) keys are not strictly ascending")


def check_assembly(
    schedule: SpGEMMSchedule,
    assembly: AssemblyMap,
    block_shape: Tuple[int, int],
    findings: List[Finding],
    label: str = "assembly",
) -> None:
    """Families 2+3: pad panel never gathered; structural coverage exact."""
    bm, bn = block_shape
    m, n = assembly.shape
    g = schedule.group
    indptr = np.asarray(assembly.indptr)
    indices = np.asarray(assembly.indices)
    gather = np.asarray(assembly.gather)
    nnz = assembly.nnz
    if indptr.shape != (m + 1,):
        _err(findings, f"{label}.indptr-shape",
             f"indptr shape {indptr.shape}, expected ({m + 1},)")
        return
    if indptr.size and int(indptr[0]) != 0:
        _err(findings, f"{label}.indptr-origin",
             f"indptr[0] = {int(indptr[0])}, expected 0")
    if (np.diff(indptr) < 0).any():
        i = int(np.argmax(np.diff(indptr) < 0))
        _err(findings, f"{label}.indptr-monotone",
             f"indptr decreases at row {i}")
    elif int(indptr[-1]) != nnz:
        _err(findings, f"{label}.indptr-total",
             f"indptr[-1] = {int(indptr[-1])} != nnz {nnz}")
    if gather.shape != (nnz,):
        _err(findings, f"{label}.gather-shape",
             f"gather shape {gather.shape}, expected ({nnz},)")
        return
    _bounds_check(findings, f"{label}.indices-bounds", indices, 0,
                  max(n, 1), "indices")
    # Columns strictly ascending within each row (canonical CSR — results
    # share these arrays, so duplicates would silently alias C entries).
    if nnz and (np.diff(indptr) >= 0).all() and int(indptr[-1]) == nnz:
        _check_column_order(findings, f"{label}.column-order", indptr, indices, n)
    # Pad-panel discipline: the flat gather space is the *real* panels
    # only. Any index >= n_panels*g*bm*bn reads the dummy pad panel of the
    # padded stream — or, in the batch-folded stream with per-element
    # stride n_panels+1, another element's panels (and on the card, past
    # the kernel's [n_panels, group*bm, bn] output).
    flat = schedule.n_panels * g * bm * bn
    bad = (gather < 0) | (gather >= max(flat, 1))
    if bad.any():
        i = int(np.argmax(bad))
        _err(findings, f"{label}.pad-panel-read",
             f"gather[{i}] = {int(gather[i])} outside the real panel "
             f"space [0, {flat}): it reads the write-only dummy pad panel")
    elif nnz:
        # Exactly-once: every structural C nnz has a distinct source slot
        # (counted on a mark per slot of the panel space, not by a sort).
        seen = np.zeros(flat, dtype=bool)
        seen[gather] = True
        n_uniq = int(np.count_nonzero(seen))
        if n_uniq != nnz:
            _err(findings, f"{label}.gather-duplicate",
                 f"{nnz - n_uniq} duplicated gather index(es): two "
                 f"C entries read the same panel slot")
    # Structural coverage: nnz must equal the schedule's C block pattern
    # trimmed to the true shape (ceil-padded edge blocks overhang).
    rows_in = np.clip(m - schedule.c_brow.astype(np.int64) * bm, 0, bm)
    cols_in = np.clip(n - schedule.c_bcol.astype(np.int64) * bn, 0, bn)
    expect = int((rows_in * cols_in).sum())
    if nnz != expect:
        _err(findings, f"{label}.coverage",
             f"assembly holds {nnz} structural nnz, schedule implies "
             f"{expect}")


def check_batch_races(
    schedule: SpGEMMSchedule,
    findings: List[Finding],
    bsz: int = 2,
    label: str = "races.batch",
) -> None:
    """Family 4 (batch-folded stream): prove single-writer per output slot,
    as the JAX package states it, over the padded triple arrays
    (:func:`~repro_torch.kernels.gustavson_spgemm.pad_schedule_arrays`):
    the batch stream's slot map ``slot = b * (n_panels + 1) + panel[t]``
    over every step. Slots of distinct ``b`` never collide exactly when
    every padded panel id sits in ``[0, n_panels]``, and within one element
    a panel slot is revisited only by one contiguous run of steps. The
    CUDA kernel's own launch is proved by :func:`check_schedule_runs`.
    """
    n_panels = schedule.n_panels
    a_slot, b_slot, panel, sub_row, start, t_pad = pad_schedule_arrays(
        schedule.a_slot, schedule.b_slot, schedule.panel,
        schedule.sub_row, schedule.start, n_panels,
    )
    stride = n_panels + 1
    _bounds_check(findings, f"{label}.padded-panel-bounds", panel, 0,
                  stride, "padded panel")
    if findings and findings[-1].check == f"{label}.padded-panel-bounds":
        return
    # Explicit slot map over the full (bsz, t_pad) stream: distinct batch
    # elements must write disjoint slot sets, and one slot's writers must
    # be contiguous in t.
    b_of = np.repeat(np.arange(bsz, dtype=np.int64), t_pad)
    t_of = np.tile(np.arange(t_pad, dtype=np.int64), bsz)
    slot = b_of * stride + panel[t_of].astype(np.int64)
    order = np.lexsort((t_of, slot))
    slot_s, b_s, t_s = slot[order], b_of[order], t_of[order]
    same = np.zeros(slot_s.shape[0], dtype=bool)
    same[1:] = slot_s[1:] == slot_s[:-1]
    if same.any():
        cross = same & (b_s != np.roll(b_s, 1))
        if cross.any():
            i = int(np.argmax(cross))
            _err(findings, f"{label}.cross-element",
                 f"output slot {int(slot_s[i])} written by batch elements "
                 f"{int(b_s[i - 1])} and {int(b_s[i])}: the batch axis is "
                 f"NOT race-free")
        gap = same & (t_s != np.roll(t_s, 1) + 1)
        # Pad triples all target one dummy slot per element with start=1
        # (each write begins by zeroing), so non-contiguity there is safe;
        # real panels must still be single contiguous runs.
        real = (slot_s % stride) < n_panels
        if (gap & real).any():
            i = int(np.argmax(gap & real))
            _err(findings, f"{label}.revisit-gap",
                 f"slot {int(slot_s[i])} revisited non-contiguously at "
                 f"grid steps t={int(t_s[i - 1])} and t={int(t_s[i])}")


def _host_runs(runs: ScheduleRuns) -> Dict[str, np.ndarray]:
    """The run arrays as host int64 numpy arrays."""
    return {name: getattr(runs, name).cpu().numpy().astype(np.int64)
            for name in ("ptr", "a_slot", "b_slot", "panel", "sub_row")}


def check_schedule_runs(
    schedule: SpGEMMSchedule,
    runs: Optional[ScheduleRuns],
    findings: List[Finding],
    label: str = "races.batch",
) -> None:
    """Family 4 (the CUDA launch): K1/K2 run ``grid = (n_tiles, bsz)`` with
    ``n_tiles = n_panels * group``; block ``(i, e)`` walks entries
    ``ptr[i]:ptr[i+1]`` of ``runs`` and writes output rows
    ``[(e * n_tiles + i) * bm, + bm)`` of ``[bsz, n_panels, group*bm, bn]``.

    A block writes the rows its grid index names, whatever its run holds,
    so the ``n_tiles * bsz`` blocks write pairwise disjoint row ranges
    that tile the output exactly when the grid is ``len(ptr) - 1`` tiles
    wide. What is left to prove: the runs' geometry is the schedule's,
    ``ptr`` has ``n_tiles + 1`` entries rising monotonically from 0 to T,
    every entry of run ``i`` belongs to tile ``i`` (each run belongs to
    exactly one tile, so no block adds another tile's products), and the
    runs hold exactly the schedule's triples of each tile in triple order
    (the summation order the bitwise invariants rest on). The batch width
    does not enter: element ``e`` reads slots ``e * nnzb + slot``, whose
    bounds :func:`repro_torch.analysis.kernel_lint.lint_plan_kernel_specs`
    checks. ``runs=None`` checks the host regrouping of ``schedule`` (what
    a plan would stage)."""
    t = schedule.num_triples
    g = max(schedule.group, 1)
    n_tiles = schedule.n_panels * schedule.group
    tile_of = (np.asarray(schedule.panel, np.int64) * g
               + np.asarray(schedule.sub_row, np.int64))
    if runs is None:
        if tile_of.size and (tile_of.min() < 0 or tile_of.max() >= n_tiles):
            _err(findings, f"{label}.runs-tile",
                 f"triple tile ids outside [0, {n_tiles}): no run can own them")
            return
        runs = stage_runs(schedule, "cpu")
    if runs.n_panels != schedule.n_panels or runs.group != schedule.group:
        _err(findings, f"{label}.runs-geometry",
             f"runs staged for {runs.n_panels} panels x group {runs.group}, the "
             f"schedule has {schedule.n_panels} x {schedule.group}")
        return
    r = _host_runs(runs)
    ptr = r["ptr"]
    if ptr.shape != (n_tiles + 1,):
        _err(findings, f"{label}.runs-ptr",
             f"ptr has shape {ptr.shape}, the launch reads ({n_tiles + 1},)")
        return
    for name in ("a_slot", "b_slot", "panel", "sub_row"):
        if r[name].shape != (t,):
            _err(findings, f"{label}.runs-ptr",
                 f"run {name} has shape {r[name].shape}, expected ({t},)")
            return
    if int(ptr[0]) != 0 or int(ptr[-1]) != t or (np.diff(ptr) < 0).any():
        _err(findings, f"{label}.runs-ptr",
             f"ptr must rise monotonically from 0 to T={t}; it runs from "
             f"{int(ptr[0])} to {int(ptr[-1])}"
             + (" and decreases" if (np.diff(ptr) < 0).any() else ""))
        return
    owner = np.repeat(np.arange(n_tiles, dtype=np.int64), np.diff(ptr))
    entry_tile = r["panel"] * g + r["sub_row"]
    if not np.array_equal(owner, entry_tile):
        i = int(np.argmax(owner != entry_tile))
        _err(findings, f"{label}.runs-tile",
             f"run entry {i} lies in the run of tile {int(owner[i])} but "
             f"belongs to tile {int(entry_tile[i])}")
        return
    order = np.argsort(tile_of, kind="stable")
    for name in ("a_slot", "b_slot"):
        want = np.asarray(getattr(schedule, name), np.int64)[order]
        if not np.array_equal(r[name], want):
            i = int(np.argmax(r[name] != want))
            _err(findings, f"{label}.runs-content",
                 f"run entry {i}: {name} {int(r[name][i])}, the schedule's "
                 f"triple {int(order[i])} of that tile has {int(want[i])}")
            return


def check_stacked_shards(
    shards,
    findings: List[Finding],
    label: str = "races.shards",
) -> None:
    """Family 4 (stacked shard schedules): the ``[n_shards, t_max]``
    constants from :func:`~repro_torch.core.schedule.stack_shard_schedules`
    keep each shard's writes inside its own ``p_max + 1``-panel buffer,
    with pads confined to the write-only dummy panel ``p_max``."""
    if not shards:
        return
    t_max = max(1, max(s.num_triples for s in shards))
    p_max = max(1, max(s.n_panels for s in shards))
    _, _, panel, _, start = stack_shard_schedules(shards, t_max, p_max)
    for i, sh in enumerate(shards):
        t = sh.num_triples
        row = panel[i]
        if (row[t:] != p_max).any():
            _err(findings, f"{label}.pad-target",
                 f"shard {i}: pad triples target panel(s) other than the "
                 f"dummy {p_max}")
        if (start[i, t:] != 1).any():
            _err(findings, f"{label}.pad-start",
                 f"shard {i}: pad triples missing start=1 (accumulator "
                 f"would carry garbage)")
        _bounds_check(findings, f"{label}.real-panel-bounds", row[:t], 0,
                      max(sh.n_panels, 1), f"shard {i} panel")
        # Shard-local gathers must never read past the shard's own real
        # panels (the stacked buffer is p_max+1 panels; slots in
        # [n_panels, p_max] hold no real panel, p_max is the shared dummy).


def check_shard_partition(
    plan,
    findings: List[Finding],
    label: str = "shards",
) -> None:
    """Family 5: partition exactness + bitwise reconstruction."""
    shards = plan._shards
    schedule: SpGEMMSchedule = plan.schedule
    if not shards:
        return
    g = schedule.group
    n_groups = -(-schedule.grid_m // g) if schedule.grid_m else 0
    # Disjoint + contiguous + covering group ranges.
    if shards[0].group_lo != 0:
        _err(findings, f"{label}.origin",
             f"first shard starts at group {shards[0].group_lo}, not 0")
    for i in range(len(shards) - 1):
        if shards[i].group_hi != shards[i + 1].group_lo:
            _err(findings, f"{label}.contiguity",
                 f"shard {i} ends at group {shards[i].group_hi} but shard "
                 f"{i + 1} starts at {shards[i + 1].group_lo}: ranges "
                 f"must tile [0, n_groups) disjointly")
    if schedule.num_triples and shards[-1].group_hi != n_groups:
        _err(findings, f"{label}.coverage",
             f"shards cover [0, {shards[-1].group_hi}) but the schedule "
             f"has exactly {n_groups} groups (under- and over-coverage "
             f"are both partition violations)")
    # Triple/panel/A spans tile the parent arrays.
    for name, lo_f, hi_f, total in (
        ("triple", "triple_lo", "triple_hi", schedule.num_triples),
        ("panel", "panel_lo", "panel_hi", schedule.n_panels),
    ):
        pos = 0
        for i, sh in enumerate(shards):
            lo, hi = getattr(sh, lo_f), getattr(sh, hi_f)
            if lo != pos or hi < lo:
                _err(findings, f"{label}.{name}-span",
                     f"shard {i} {name} span [{lo}, {hi}) does not "
                     f"continue at {pos}")
                return
            pos = hi
        if pos != total:
            _err(findings, f"{label}.{name}-span",
                 f"shard {name} spans cover {pos} of {total}")
    # Bitwise reconstruction from the serialized bounds vector — the
    # exact round trip persistence relies on.
    bounds = shards_to_bounds(shards)
    try:
        rebuilt = shards_from_bounds(schedule, bounds)
    except ValueError as e:
        _err(findings, f"{label}.bounds", f"bounds rejected: {e}")
        return
    for i, (sh, rb) in enumerate(zip(shards, rebuilt)):
        for f in ("group_lo", "group_hi", "triple_lo", "triple_hi",
                  "panel_lo", "panel_hi", "a_lo", "a_hi"):
            if getattr(sh, f) != getattr(rb, f):
                _err(findings, f"{label}.rebase",
                     f"shard {i}.{f}: stored {getattr(sh, f)} != "
                     f"rebuilt {getattr(rb, f)}")
        for f in ("a_slot", "b_slot", "panel", "sub_row", "start",
                  "panel_group", "panel_bcol", "c_brow", "c_bcol"):
            a = np.asarray(getattr(sh.schedule, f))
            b = np.asarray(getattr(rb.schedule, f))
            if a.shape != b.shape or a.dtype != b.dtype \
                    or not np.array_equal(a, b):
                _err(findings, f"{label}.rebase",
                     f"shard {i} local schedule field {f!r} differs from "
                     f"its bitwise reconstruction")
                break
    # Per-shard assembly slices concatenate to the plan assembly.
    asms = plan._shard_assemblies
    if asms:
        if sum(a.nnz for a in asms) != plan.assembly.nnz:
            _err(findings, f"{label}.assembly-cover",
                 f"shard assemblies hold "
                 f"{sum(a.nnz for a in asms)} nnz, plan assembly "
                 f"{plan.assembly.nnz}")
        else:
            cat = np.concatenate(
                [np.asarray(a.indices) for a in asms]
            ) if plan.assembly.nnz else np.asarray(plan.assembly.indices)
            if not np.array_equal(cat, np.asarray(plan.assembly.indices)):
                _err(findings, f"{label}.assembly-concat",
                     "concatenated shard CSR columns differ from the "
                     "plan-wide assembly")
        for i, (sh, asm) in enumerate(zip(shards, asms)):
            flat = sh.n_panels * g * plan._bm * plan._bn
            gth = np.asarray(asm.gather)
            if gth.size and (int(gth.max()) >= max(flat, 1)
                             or int(gth.min()) < 0):
                _err(findings, f"{label}.gather-bounds",
                     f"shard {i} gather reads outside its {sh.n_panels} "
                     f"real panels (flat space {flat})")


def check_compact(
    plan,
    findings: List[Finding],
    label: str = "compact",
) -> None:
    """Family 6: the compacted nnz-exact output map.

    The compact map reuses the exactly-once coverage proof of the block
    assembly (family 3): it must be a canonical CSR whose gather is a
    duplicate-free *subset* of the block gather. Combined with the block
    map's pad-panel and exactly-once checks, that proves every compacted
    C element reads exactly one kernel output slot and no slot feeds two
    elements.
    """
    assembly: AssemblyMap = plan.assembly
    compact: AssemblyMap = plan.compact
    m, n = compact.shape
    indptr = np.asarray(compact.indptr)
    indices = np.asarray(compact.indices)
    gather = np.asarray(compact.gather)
    nnz = compact.nnz
    if tuple(compact.shape) != tuple(assembly.shape):
        _err(findings, f"{label}.shape",
             f"compact shape {compact.shape} != assembly {assembly.shape}")
        return
    if indptr.shape != (m + 1,):
        _err(findings, f"{label}.indptr-shape",
             f"indptr shape {indptr.shape}, expected ({m + 1},)")
        return
    if indptr.size and int(indptr[0]) != 0:
        _err(findings, f"{label}.indptr-origin",
             f"indptr[0] = {int(indptr[0])}, expected 0")
    if (np.diff(indptr) < 0).any():
        i = int(np.argmax(np.diff(indptr) < 0))
        _err(findings, f"{label}.indptr-monotone",
             f"indptr decreases at row {i}")
    elif int(indptr[-1]) != nnz:
        _err(findings, f"{label}.indptr-total",
             f"indptr[-1] = {int(indptr[-1])} != nnz {nnz}")
    if gather.shape != (nnz,):
        _err(findings, f"{label}.gather-shape",
             f"gather shape {gather.shape}, expected ({nnz},)")
        return
    _bounds_check(findings, f"{label}.indices-bounds", indices, 0,
                  max(n, 1), "indices")
    if nnz > assembly.nnz:
        _err(findings, f"{label}.size",
             f"compact map holds {nnz} nnz, more than the {assembly.nnz} "
             f"block-structural slots it selects from")
    if nnz and (np.diff(indptr) >= 0).all() and int(indptr[-1]) == nnz:
        _check_column_order(findings, f"{label}.column-order", indptr, indices, n)
    if nnz:
        # Exactly-once, inherited: subset of the block gather space...
        if not np.isin(gather, np.asarray(assembly.gather)).all():
            _err(findings, f"{label}.subset",
                 "compact gather reads slot(s) outside the block "
                 "assembly's gather space")
        # ...with no slot feeding two compacted elements.
        uniq = np.unique(gather)
        if uniq.shape[0] != nnz:
            _err(findings, f"{label}.gather-duplicate",
                 f"{nnz - uniq.shape[0]} duplicated gather index(es): two "
                 f"compacted C entries read the same panel slot")
    # Bitwise re-derivation from the block assembly + the compact pattern
    # itself — the compact analogue of assembly.rebuild.
    if not any(f.severity == "error" and f.check.startswith(label)
               for f in findings):
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
        try:
            fresh = build_compact_map(assembly, rows, indices)
        except Exception as e:  # noqa: BLE001 - any failure is a finding
            _err(findings, f"{label}.rebuild",
                 f"compact map not re-derivable from the block assembly: "
                 f"{type(e).__name__}: {e}")
            return
        for f in ("gather", "indptr", "indices"):
            a = np.asarray(getattr(compact, f))
            b = np.asarray(getattr(fresh, f))
            if a.shape != b.shape or not np.array_equal(a, b):
                _err(findings, f"{label}.rebuild",
                     f"stored compact {f!r} differs from its re-derived "
                     f"map")
                return
    # Sharded plans slice the compact map per shard; the slices must
    # exactly tile it (the executor's packed-value layout depends on it).
    shard_compacts = getattr(plan, "_shard_compacts", None)
    if shard_compacts:
        if sum(a.nnz for a in shard_compacts) != nnz:
            _err(findings, f"{label}.shard-cover",
                 f"shard compact maps hold "
                 f"{sum(a.nnz for a in shard_compacts)} nnz, plan compact "
                 f"{nnz}")
        elif nnz:
            cat = np.concatenate(
                [np.asarray(a.indices) for a in shard_compacts]
            )
            if not np.array_equal(cat, indices):
                _err(findings, f"{label}.shard-concat",
                     "concatenated shard compact columns differ from the "
                     "plan-wide compact map")


def _rebuild_cross_check(plan, findings: List[Finding]) -> None:
    """Re-derive the assembly map from the plan's own schedule and compare
    bitwise — the strongest corruption detector for persisted artifacts
    (a digest-valid file whose arrays were *consistently* rewritten still
    cannot match an independent re-derivation)."""
    try:
        fresh = build_assembly_map(
            plan.schedule, (plan._bm, plan._bn), (plan._m, plan._n)
        )
    except Exception as e:  # noqa: BLE001 - any failure is a finding
        _err(findings, "assembly.rebuild",
             f"assembly map not re-derivable from the schedule: "
             f"{type(e).__name__}: {e}")
        return
    for f in ("gather", "indptr", "indices"):
        a = np.asarray(getattr(plan.assembly, f))
        b = np.asarray(getattr(fresh, f))
        if a.shape != b.shape or not np.array_equal(a, b):
            _err(findings, "assembly.rebuild",
                 f"stored assembly {f!r} differs from the schedule's "
                 f"re-derived map")
            return
    if tuple(plan.assembly.shape) != tuple(fresh.shape):
        _err(findings, "assembly.rebuild",
             f"stored assembly shape {plan.assembly.shape} != re-derived "
             f"{fresh.shape}")


def verify_plan(
    plan,
    *,
    batch_sizes: Tuple[int, ...] = (2, 3),
    rebuild_check: bool = True,
) -> VerifyReport:
    """Statically verify one plan. Returns a :class:`VerifyReport`;
    ``report.raise_if_failed()`` raises :class:`PlanVerificationError`.

    ``batch_sizes`` are the symbolic batch widths the race checks run at
    (disjointness is stride-structural, so two small sizes suffice).
    ``rebuild_check=False`` skips the full assembly re-derivation (the
    one check whose cost is O(symbolic build); everything else is a few
    linear passes over the schedule arrays).

    The launch half of the race check (:func:`check_schedule_runs`) reads
    the runs the plan's executor staged (copied back from its device once)
    and runs only while no error has been found: it presupposes a
    well-formed schedule, so ``checks_run`` and the finding names equal the
    JAX package's ``verify_plan`` on the same plan.
    """
    t0 = lap_t = time.perf_counter()
    secs: Dict[str, float] = {}

    def lap(check: str) -> None:
        nonlocal lap_t
        now = time.perf_counter()
        secs[check] = secs.get(check, 0.0) + now - lap_t
        lap_t = now

    findings: List[Finding] = []
    checks = [
        "schedule", "assembly", "races.batch",
    ]
    schedule: SpGEMMSchedule = plan.schedule
    nnzb_a = int(plan._a_shape[0]) if len(plan._a_shape) == 3 else 0
    nnzb_b = int(plan._b_shape[0]) if len(plan._b_shape) == 3 else 0
    sharded = hasattr(plan, "_shards") and getattr(plan, "n_shards", 0) > 0
    check_schedule(schedule, nnzb_a, nnzb_b, findings)
    lap("schedule")
    check_assembly(schedule, plan.assembly, (plan._bm, plan._bn), findings)
    lap("assembly")
    staged = _staged_runs(plan)
    for bsz in batch_sizes:
        check_batch_races(schedule, findings, bsz=bsz)
    # The launch the kernel really makes, over the staged runs (a sharded
    # plan stages per shard, below): only on a well-formed schedule.
    if not sharded and not _failed(findings):
        check_schedule_runs(schedule, staged.get(0), findings)
    lap("races.batch")
    if getattr(plan, "compact", None) is not None:
        checks.append("compact")
        check_compact(plan, findings)
        lap("compact")
    if rebuild_check:
        checks.append("assembly.rebuild")
        _rebuild_cross_check(plan, findings)
        lap("assembly.rebuild")
    # Configuration provenance: a tuned config that no longer matches the
    # plan's symbolic facts was ignored at apply time — surface it.
    stale = getattr(plan, "_stale_tuned", None)
    if stale is not None:
        checks.append("tuned")
        findings.append(Finding(
            check="tuned.stale-config",
            severity="warning",
            message=(
                f"persisted tuned config {stale!r} no longer matches the "
                f"plan's symbolic facts; it was ignored and the plan runs "
                f"with config_source="
                f"{plan.report.config_source!r} (re-run the autotuner to "
                f"refresh the sidecar)"
            ),
        ))
        lap("tuned")
    if sharded:
        checks += ["shards", "races.shards"]
        check_shard_partition(plan, findings)
        check_stacked_shards(plan._shards, findings)
        for i, sh in enumerate(plan._shards):
            if sh.num_triples:
                check_schedule(
                    sh.schedule, sh.a_hi - sh.a_lo, nnzb_b, findings,
                    label=f"shard{i}.schedule",
                )
        lap("shards")
        # Each launching shard's staged runs.
        for i, runs in sorted(staged.items()):
            if _failed(findings):
                break
            check_schedule_runs(plan._shards[i].schedule, runs, findings,
                                label="races.shards")
        lap("races.shards")
    return VerifyReport(
        plan_kind=plan.kind,
        sharded=bool(sharded),
        backend=getattr(plan, "backend", "?"),
        checks_run=checks,
        findings=findings,
        elapsed_s=time.perf_counter() - t0,
        check_seconds=secs,
    )


def _failed(findings: List[Finding]) -> bool:
    return any(f.severity == "error" for f in findings)


def _staged_runs(plan) -> Dict[int, ScheduleRuns]:
    """The runs the plan's executor staged (``{shard: runs}``; ``{0:
    runs}`` for a single-device plan), or ``{}`` for a plan without an
    executor (empty or released)."""
    with plan._lock:
        ex = plan._executor
    return {} if ex is None else ex.staged_runs()
