"""Per-pattern plan autotuning: model-pruned, probe-measured configs.

FSpGEMM tunes its FPGA design per matrix — the paper picks PE count and
buffer depths per workload and amortizes the choice over every numeric
run that reuses the pattern. This module is that idea as a service knob
for the plan/execute stack: given one sparsity pattern, search the plan
config space

    (tile, group)      — structural: changes the schedule and C blocking
    chunk_bytes        — executor batch-fusion budget (``batch_chunk``)
    pipeline depth     — submit/collect stages for streamed serving

and persist the winner next to the plan artifacts so every later process
serving the same pattern starts tuned, with **zero** probe executions.

Two-stage search (cheap model first, short measurements second):

1. **Model pruning.** Every candidate ``(tile, group)`` builds (or cache-
   hits) its plan — symbolic phase only — and is ranked by the roofline
   estimate :func:`repro_torch.core.perfmodel.roofline_seconds` over the
   schedule's exact FLOP/traffic counts
   (:func:`repro_torch.core.perfmodel.spgemm_schedule_traffic`, fed by the
   plan report's triple/fetch counters) on the plan's device: the card's
   :func:`~repro_torch.core.perfmodel.cuda_device_model` for the
   ``cuda`` backend, the paper's Xeon for the plain ``torch`` version
   (the JAX package's CPU ranking). Only the top ``model_top_k`` survive
   — plus the caller's requested config, always, so measurement can
   never do worse than the default by construction (argmax over a set
   that contains it).
2. **Measured probes.** Survivors (crossed with the chunk-bytes
   candidates) run short interleaved min-of-N timed ``execute_batch``
   probes on synthetic small-integer values — the probe machinery of
   :func:`repro_torch.core.tuning.measure_chunk_knee` (warmup off-clock,
   interleaved repeats so drift lands evenly, min-of-N; each measurement
   waits for the device inside its timed region). The best measured
   config wins; pipeline depth is then probed on the winner only
   (``plan.execute_stream`` over a short value stream, K1 per step).

On the card every probe runs the hand-written kernels (K2 for the batch
probes, K1 for the depth probes); a probe that fails raises.

The result is a :class:`TunedConfig` carrying measured values/s for the
winner *and* the requested default, the model's rank of the winner, and
the model-vs-measured ranking agreement (concordant-pair fraction) — the
auditable record of how much the model pruning can be trusted on this
device. ``spgemm_plan(..., autotune=True)`` and
``SpGEMMGateway.register(..., autotune=True)`` run this search and apply
the winner; the config persists through the plan cache's disk tier
(:meth:`PlanCache.tuned_put`, a :class:`PlanStore` sidecar record under
the same key fields as the port's plans: backend and device included) so
a warm restart rehydrates schedule **and** tuned config from disk.
Config precedence stays operator-safe: ``REPRO_SPGEMM_CHUNK_BYTES``
still beats any tuned value (see ``resolve_chunk_bytes``).

Numerics are untouched by construction: ``chunk_bytes`` and pipeline
depth are bitwise-invariant (chunked/streamed results equal per-element
executes), and a tuned ``(tile, group)`` produces results bitwise-equal
to an untuned plan built directly at that tile/group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.perfmodel import (
    CPU_XEON_E5_2637,
    DeviceModel,
    cuda_device_model,
    roofline_seconds,
    spgemm_schedule_traffic,
)
from repro_torch.core.tuning import interleaved_best_ms
from repro_torch.sparse.formats import BCSR, BCSV
from repro_torch.spgemm.cache import PlanCache, default_cache
from repro_torch.spgemm.executor import _default_chunk_policy
from repro_torch.spgemm.plan import (
    SpGEMMPlan,
    _mesh_key,
    _normalize_tile,
    _plan_device,
    resolve_backend,
    spgemm_plan,
)

__all__ = [
    "TunedConfig",
    "autotune_plan",
    "probe_run_count",
]

# Global count of measured probe executions (one per timed thunk run,
# warmups included). The warm-restart acceptance criterion: loading a
# persisted TunedConfig must leave this counter untouched.
_PROBE_RUNS = 0


def probe_run_count() -> int:
    return _PROBE_RUNS


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """The autotuner's winning plan config plus its measurement record.

    ``values_per_s`` / ``default_values_per_s`` are probe-measured batch
    throughputs (value sets per second) for the winner and for the
    caller's requested config on the same device; their ratio is the
    predicted warm-path speedup. ``model_rank`` is the roofline model's
    0-based rank of the winning (tile, group) among all candidates, and
    ``ranking_agreement`` the concordant-pair fraction between model
    estimates and measured probe times over the survivors — 1.0 means
    the model ordered every measured pair correctly.
    ``source`` records provenance: ``"probed"`` (searched here) or
    ``"persisted"`` (rehydrated from the disk sidecar, zero probes).
    """

    tile: Tuple[int, int, int]
    group: int
    chunk_bytes: Optional[int]  # per-set knee budget; None = policy table
    pipeline_depth: int
    values_per_s: float
    default_values_per_s: float
    model_rank: int
    ranking_agreement: float
    probes: int  # timed probe executions this search paid
    source: str = "probed"

    def to_meta(self) -> dict:
        """JSON-able dict for the PlanStore sidecar record. Floats ride
        through ``repr`` (via json) bitwise — round-tripping a persisted
        config reproduces the measured numbers exactly."""
        d = dataclasses.asdict(self)
        d["tile"] = list(self.tile)
        return d

    @classmethod
    def from_meta(cls, meta: dict, *, source: Optional[str] = None) -> "TunedConfig":
        kw = dict(meta)
        kw["tile"] = tuple(int(t) for t in kw["tile"])
        kw["group"] = int(kw["group"])
        cb = kw.get("chunk_bytes")
        kw["chunk_bytes"] = None if cb is None else int(cb)
        kw["pipeline_depth"] = int(kw["pipeline_depth"])
        kw["probes"] = int(kw["probes"])
        kw["model_rank"] = int(kw["model_rank"])
        if source is not None:
            kw["source"] = source
        return cls(**kw)

    @property
    def speedup(self) -> float:
        """Measured winner-over-default throughput ratio."""
        if self.default_values_per_s <= 0:
            return 1.0
        return self.values_per_s / self.default_values_per_s


def _model_device(plan: SpGEMMPlan) -> DeviceModel:
    """The roofline device for candidate ranking: the card (at the plan's
    value dtype's peak) for the ``cuda`` backend, the paper's Xeon for the
    plain version. Ordering is all that matters for pruning."""
    if plan.backend == "cuda":
        return cuda_device_model(plan.device, plan._a_dtype)
    return CPU_XEON_E5_2637


def _kernel_takes(tile: Tuple[int, int, int]) -> bool:
    """True when K1 takes every dimension of ``tile``: multiples of 16 in
    [16, 128] (``kernels/gustavson_spgemm.py``'s launch check)."""
    return all(d % 16 == 0 and 16 <= d <= 128 for d in tile)


def _tile_ladder(t: int, floor: int = 8, cap: int = 256) -> List[int]:
    """{t/2, t, 2t} clipped to [floor, cap] — the structural search axis
    around the caller's request."""
    out = []
    for c in (t // 2, t, t * 2):
        c = max(floor, min(cap, int(c)))
        if c not in out:
            out.append(c)
    return out


def _default_candidates(
    tile: Tuple[int, int, int], group: int
) -> List[Tuple[Tuple[int, int, int], int]]:
    """(tile, group) grid: square-tile ladder x group ladder around the
    request. Tiles stay square (bm == bk == bn) unless the caller asked
    for a rectangular tile, in which case the whole tuple scales."""
    bm, bk, bn = tile
    if bm == bk == bn:
        tiles = [(t, t, t) for t in _tile_ladder(bm)]
    else:
        tiles = []
        for s in (0.5, 1.0, 2.0):
            cand = tuple(max(8, min(256, int(d * s))) for d in tile)
            if cand not in tiles:
                tiles.append(cand)
    groups = []
    for g in (max(1, group // 2), group, group * 2):
        if g not in groups:
            groups.append(g)
    return [(t, g) for t in tiles for g in groups]


def _chunk_candidates(plan: SpGEMMPlan) -> List[Optional[int]]:
    """chunk_bytes (small_set knee) candidates: the policy default
    (``None``) plus a half/double bracket of the plan device's own row."""
    small, _ = _default_chunk_policy(plan.device)
    out: List[Optional[int]] = [None]
    for c in (small // 2, small * 2):
        if c > 0 and c not in out:
            out.append(int(c))
    return out


def _synthetic_batch(plan: SpGEMMPlan, batch: int, seed: int):
    """A [batch, ...] pair of small-integer value sets matching the
    plan's numeric-phase contract (element vectors or packed blocks), as
    host tensors of the plan's value dtypes. The integers are drawn with
    numpy (bfloat16 has no numpy dtype) and are exact in float32 and
    bfloat16 — probe runs are bitwise-comparable across configs, the same
    trick as ``tuning._random_int_coo``."""
    rng = np.random.default_rng(seed)
    want_a, want_b = plan.value_shapes()

    def draw(shape, dtype):
        ints = rng.integers(-3, 4, (batch,) + tuple(shape)).astype(np.float32)
        return torch.from_numpy(ints).to(dtype)

    return (
        draw(want_a, plan._a_dtype),
        draw(want_b, plan._b_dtype),
    )


def _ranking_agreement(
    model_s: Sequence[float], measured_ms: Sequence[float]
) -> float:
    """Concordant-pair fraction between the model's and the measured
    ordering (Kendall-style, ties count as half). 1.0 = the model
    ordered every measured pair correctly; 0.5 = no information."""
    n = len(model_s)
    pairs = concordant = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            dm = model_s[i] - model_s[j]
            dt = measured_ms[i] - measured_ms[j]
            pairs += 1
            if dm == 0 or dt == 0:
                concordant += 0.5
            elif (dm > 0) == (dt > 0):
                concordant += 1
    return concordant / pairs if pairs else 1.0


def _probe_batch_fn(
    plan: SpGEMMPlan, a_batch, b_batch, chunk_bytes: Optional[int]
) -> Callable:
    """A probe thunk: one full ``execute_batch`` under a temporarily
    applied chunk budget. The plan's resolved policy is swapped in and
    restored around the call so concurrent (non-probe) users of a shared
    cached plan never see a half-tuned executor for long — and the probe
    still measures the real ``batch_chunk`` path, not a bypass. Its
    result is host values (``execute_batch`` copies C to the host)."""

    def run():
        global _PROBE_RUNS
        _PROBE_RUNS += 1
        ex = plan._executor
        if ex is None:
            return np.zeros(1, np.float32)
        saved = ex._chunk_policy
        ex.set_chunk_bytes(chunk_bytes)
        try:
            out = plan.execute_batch(a_batch, b_batch)
        finally:
            ex._chunk_policy = saved
        return out[0].data if out else np.zeros(1, np.float32)

    return run


def _probe_stream_fn(plan: SpGEMMPlan, a_batch, b_batch, depth: int) -> Callable:
    """A pipeline-depth probe thunk: stream the batch through a
    ``depth``-deep submit/collect pipeline (the serving path a gateway
    round takes)."""

    def run():
        global _PROBE_RUNS
        _PROBE_RUNS += 1
        last = None
        for out in plan.execute_stream(
            ((a_batch[i], b_batch[i]) for i in range(a_batch.shape[0])),
            depth=depth,
        ):
            last = out
        return last.data if last is not None else np.zeros(1, np.float32)

    return run


def _check_kernel_tiles(grid, backend: str, what: str) -> None:
    """On the ``cuda`` backend every tile of ``grid`` must be one K1 takes."""
    if backend != "cuda":
        return
    bad = [t for t, _ in grid if not _kernel_takes(t)]
    if bad:
        raise ValueError(
            f"{what}: the CUDA kernel takes tile dims that are multiples of 16 "
            f"in [16, 128]; got {bad}"
        )


def _search_grid(req_tile, req_group, candidates, backend: str):
    """The (tile, group) grid of an element plan's search: ``candidates``
    (with the request appended) or the default grid around the request,
    keeping on the ``cuda`` backend only the tiles K1 takes. A refused
    explicit candidate raises rather than being skipped."""
    if candidates is not None:
        grid = [(_normalize_tile(t), int(g)) for t, g in candidates]
        _check_kernel_tiles(grid, backend, "candidates")
        if (req_tile, req_group) not in grid:
            grid.append((req_tile, req_group))
        return grid
    grid = _default_candidates(req_tile, req_group)
    if backend == "cuda":
        grid = [(t, g) for t, g in grid if _kernel_takes(t)]
    return grid


def autotune_plan(
    a,
    b,
    *,
    tile: Union[int, Tuple[int, ...]] = 64,
    group: int = 4,
    backend: str = "auto",
    device="cuda",
    cache: Optional[PlanCache] = None,
    mesh=None,
    mesh_axis: Optional[str] = None,
    pattern_token: Optional[str] = None,
    candidates: Optional[Sequence[Tuple[Tuple[int, int, int], int]]] = None,
    chunk_candidates: Optional[Sequence[Optional[int]]] = None,
    depth_candidates: Sequence[int] = (1, 2, 4),
    model_top_k: int = 3,
    probe_batch: int = 8,
    repeats: int = 3,
    seed: int = 0,
    timer=None,
    force: bool = False,
    record: Optional[dict] = None,
) -> SpGEMMPlan:
    """Search the plan config space for ``(a, b)``'s pattern and return
    the winning plan with its :class:`TunedConfig` applied.

    ``device="cuda"`` (the default, as in ``spgemm_plan``) probes the
    hand-written kernels on the card and raises without one;
    ``device="cpu"`` probes the plain PyTorch version.

    The search key is the *requested* config's plan cache key (pattern,
    tile, group, backend, device, shard key), so the persisted record is
    found again by any process asking to autotune the same pattern at the
    same starting point on the same device. On a sidecar hit the tuned
    plan is rebuilt/fetched directly — **zero probes** — unless
    ``force=True`` re-measures.

    ``timer`` injects a ``perf_counter``-like clock into every
    measurement (exactly two calls per timed run) — the determinism seam
    tuner tests use. All other knobs bound the search: ``candidates``
    overrides the (tile, group) grid, ``model_top_k`` how many survive
    the roofline pruning, ``probe_batch``/``repeats`` the measured-probe
    cost.

    On the ``cuda`` backend the default grid keeps only the tiles K1
    takes (dims that are multiples of 16 in [16, 128]; the reference
    grid spans [8, 256]), before any plan is built; a requested tile or
    an explicit candidate that K1 refuses raises ``ValueError``. On
    ``torch`` the grid is the reference's exactly.

    Block-format inputs (BCSV/BCSR) fix the tile/group structurally, so
    the search restricts to ``chunk_bytes`` and pipeline depth.

    ``record``, a dict, is filled with what a probed search saw (for
    reports): ``"candidates"`` (each grid entry's tile, group and model
    seconds, in model order), ``"probes"`` (each measured entry's tile,
    group, chunk bytes and best ms) and ``"depths"`` (depth -> best ms).
    A sidecar hit leaves it empty.
    """
    global _PROBE_RUNS
    backend = resolve_backend(backend, _plan_device(device, mesh))
    if cache is None:
        cache = default_cache()
    req_tile = _normalize_tile(tile)
    req_group = int(group)
    block_input = isinstance(a, BCSV) and isinstance(b, BCSR)
    if not block_input:
        _check_kernel_tiles([(req_tile, req_group)], backend, "requested tile")

    # The sidecar key = the requested config's standard plan key. Building
    # the requested plan first also gives the digest (and seeds the cache
    # for the default-probe stage).
    base_plan = spgemm_plan(
        a, b, tile=req_tile, group=req_group, backend=backend, device=device,
        cache=cache, mesh=mesh, mesh_axis=mesh_axis, pattern_token=pattern_token,
    )
    block_input = base_plan.kind == "block"
    if block_input:
        # Block formats fix tile/group structurally (spgemm_plan ignores
        # the args); rebase the search on the plan's real config so the
        # sidecar key and TunedConfig match what was actually built.
        req_tile = tuple(int(t) for t in base_plan.report.tile)
        req_group = int(base_plan.report.group)
        _check_kernel_tiles([(req_tile, req_group)], backend, "block tile")
    device = base_plan.device
    shard_key = _mesh_key(mesh, mesh_axis)
    base_key = (
        base_plan.report.pattern_key, req_tile, req_group, backend, str(device),
        shard_key,
    )

    if not force:
        meta = cache.tuned_get(base_key)
        if meta is not None:
            cfg = TunedConfig.from_meta(meta, source="persisted")
            if cfg.tile == req_tile and cfg.group == req_group:
                win = base_plan
            else:
                win = spgemm_plan(
                    a, b, tile=cfg.tile, group=cfg.group, backend=backend,
                    device=device, cache=cache, mesh=mesh, mesh_axis=mesh_axis,
                )
            win.apply_tuned_config(cfg)
            return win

    # -- stage 1: model pruning over the (tile, group) grid ---------------
    if block_input:
        grid = [(req_tile, req_group)]
    else:
        grid = _search_grid(req_tile, req_group, candidates, backend)

    model = _model_device(base_plan)
    ranked = []  # (model_seconds, tile, group, plan)
    for t, g in grid:
        if (t, g) == (req_tile, req_group):
            p = base_plan
        else:
            p = spgemm_plan(
                a, b, tile=t, group=g, backend=backend, device=device,
                cache=cache, mesh=mesh, mesh_axis=mesh_axis,
            )
        r = p.report
        traffic = spgemm_schedule_traffic(
            num_triples=r.num_triples, nnzb_a=r.nnzb_a,
            b_fetches=r.b_fetches, n_panels=r.n_panels,
            tile=t, group=g, dtype_bytes=p._a_dtype.itemsize,
        )
        est = roofline_seconds(traffic["flops"], traffic["bytes"], model)
        ranked.append((est, t, g, p))
    ranked.sort(key=lambda x: (x[0], x[1], x[2]))
    model_rank_of = {
        (t, g): i for i, (_, t, g, _) in enumerate(ranked)
    }
    survivors = ranked[: max(1, int(model_top_k))]
    # The requested config always survives: measurement then cannot pick
    # a config worse than the default (argmax over a set containing it).
    if all((t, g) != (req_tile, req_group) for _, t, g, _ in survivors):
        survivors.append(next(
            x for x in ranked if (x[1], x[2]) == (req_tile, req_group)
        ))

    # -- stage 2: measured probes (interleaved min-of-N) ------------------
    chunks = (
        list(chunk_candidates) if chunk_candidates is not None
        else _chunk_candidates(base_plan)
    )
    probes_before = _PROBE_RUNS
    entries = []  # (model_s, tile, group, plan, chunk_bytes, fn)
    for est, t, g, p in survivors:
        a_b, b_b = _synthetic_batch(p, probe_batch, seed)
        for cb in chunks:
            entries.append(
                (est, t, g, p, cb, _probe_batch_fn(p, a_b, b_b, cb))
            )
    # Warmup off-clock: first run of each thunk pays staging and the
    # allocator's first requests.
    for e in entries:
        e[5]()
    times = interleaved_best_ms([e[5] for e in entries], repeats, timer=timer)

    best_i = int(np.argmin(times))
    _, win_t, win_g, win_plan, win_cb, _ = entries[best_i]
    # The default config's measured time: the requested (tile, group) at
    # the policy-table chunk (None) — present by construction.
    default_i = next(
        i for i, e in enumerate(entries)
        if (e[1], e[2]) == (req_tile, req_group) and e[4] is None
    )

    # Model-vs-measured agreement over the per-(tile, group) best times —
    # the quantity the model actually ranked.
    per_cfg: dict = {}
    for e, ms in zip(entries, times):
        k = (e[1], e[2])
        if k not in per_cfg or ms < per_cfg[k][1]:
            per_cfg[k] = (e[0], ms)
    agreement = _ranking_agreement(
        [v[0] for v in per_cfg.values()], [v[1] for v in per_cfg.values()]
    )

    # -- stage 3: pipeline depth, winner only ------------------------------
    depth = 2
    depths = [int(d) for d in depth_candidates if int(d) >= 1]
    d_times = []
    if len(depths) > 1:
        a_b, b_b = _synthetic_batch(win_plan, probe_batch, seed)
        fns = [_probe_stream_fn(win_plan, a_b, b_b, d) for d in depths]
        for fn in fns:
            fn()  # warmup off-clock
        d_times = interleaved_best_ms(fns, repeats, timer=timer)
        depth = depths[int(np.argmin(d_times))]
    elif depths:
        depth = depths[0]
    if record is not None:
        record["candidates"] = [
            {"tile": list(t), "group": g, "model_s": est} for est, t, g, _ in ranked]
        record["probes"] = [
            {"tile": list(e[1]), "group": e[2], "chunk_bytes": e[4], "ms": ms}
            for e, ms in zip(entries, times)]
        record["depths"] = dict(zip(depths, d_times))

    def to_vps(ms: float) -> float:
        if not math.isfinite(ms) or ms <= 0:
            return 0.0
        return probe_batch / (ms * 1e-3)

    cfg = TunedConfig(
        tile=win_t,
        group=win_g,
        chunk_bytes=win_cb,
        pipeline_depth=depth,
        values_per_s=to_vps(times[best_i]),
        default_values_per_s=to_vps(times[default_i]),
        model_rank=model_rank_of[(win_t, win_g)],
        ranking_agreement=agreement,
        probes=_PROBE_RUNS - probes_before,
        source="probed",
    )
    cache.tuned_put(base_key, cfg.to_meta())
    win_plan.apply_tuned_config(cfg)
    return win_plan
