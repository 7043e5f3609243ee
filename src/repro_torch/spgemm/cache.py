"""Two-tier plan cache + sparsity-pattern fingerprinting.

The paper's host program converts inputs "once" (Sec. 4.3); the serving
north-star multiplies one sparsity pattern with fresh values millions of
times. The cache makes that amortization automatic — and, with the disk
tier, *durable*: plans are keyed on ``(pattern hash, tile, group, backend,
device, mesh key)`` (the port's backend names, ``"cuda"`` / ``"torch"``,
and the device the plan stages its constants on) so any caller presenting
a pattern-equal input gets the already-built plan object back, paying
only the numeric phase.

Tiers, checked in order:

1. **memory** — a thread-safe LRU of live plan objects (count +
   ``max_bytes`` budgets), exactly the pre-persistence behavior;
2. **disk** (opt-in: ``PlanCache(disk_dir=...)``, or
   ``REPRO_TORCH_SPGEMM_PLAN_DIR`` for the process-default cache) — the
   value-independent symbolic artifacts in a
   :class:`~repro_torch.spgemm.persist.PlanStore`. A memory miss tries a
   verified disk load (rehydrated through the caller's ``loader``); any
   load failure silently falls back to a fresh symbolic build, and fresh
   builds are written back so the *next* process starts warm.

Locks: a plan cached here is shared across callers and threads. The
cache's lock is always taken before a plan's (an LRU eviction reads each
candidate's ``in_flight`` under the cache lock), and no plan method takes
the cache lock while it holds its own (``SpGEMMPlan.release`` drops the
plan lock before it evicts itself). Loads and builds run outside the
cache lock.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.spgemm.persist import PLAN_DIR_ENV, PlanStore

__all__ = ["CacheStats", "PlanCache", "default_cache", "pattern_digest"]


def pattern_digest(*arrays: np.ndarray, meta: Tuple = ()) -> str:
    """Stable hex digest of a sparsity pattern (index arrays + shape meta).

    Values are deliberately excluded — two inputs with the same nonzero
    support but different values hash identically, which is exactly the
    plan-reuse contract.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(meta).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class CacheStats:
    """Live counters of one :class:`PlanCache`.

    Exposed as the ``PlanCache.stats`` attribute; *calling* it
    (``cache.stats()``) snapshots everything — counters, derived rates,
    and residency — into a plain dict (the form surfaced through
    ``PlanReport.as_dict()`` and the benchmark output).
    """

    hits: int = 0  # memory-tier hits
    misses: int = 0  # memory-tier misses (may still hit disk)
    token_hits: int = 0  # hits served through a pattern-token alias
    # (no to_coo / digest paid; also counted in ``hits``)
    evictions: int = 0
    resident_plans: int = 0  # plans currently held
    resident_bytes: int = 0  # insert-time host_nbytes() of held plans
    # Disk tier (all zero when the tier is disabled).
    disk_hits: int = 0  # memory misses served by a verified disk load
    disk_misses: int = 0  # memory misses with no usable disk entry
    loads: int = 0  # successful plan rehydrations (== disk_hits)
    load_failures: int = 0  # well-formed files the loader rejected
    stores: int = 0  # fresh builds written back to disk
    token_disk_hits: int = 0  # token lookups resolved through the
    # persisted alias index (a restarted worker's token_get hitting disk
    # without ever paying the first COO digest)
    # Tuned-config sidecar records (the autotuner's persistence tier).
    tuned_hits: int = 0  # tuned-config lookups served (memory or disk)
    tuned_misses: int = 0  # lookups with no tuned record anywhere
    tuned_stores: int = 0  # tuned configs written to the disk sidecar
    # Plan-composition lookups (plan_from_structural_pattern): plans
    # keyed off a prior plan's structural output pattern rather than a
    # COO digest. Also counted in hits/misses like any other lookup.
    chain_lookups: int = 0
    # The owning cache's PlanStore (snapshot source only, not a counter).
    store: Optional[PlanStore] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def __call__(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "token_hits": self.token_hits,
            "evictions": self.evictions,
            "resident_plans": self.resident_plans,
            "resident_bytes": self.resident_bytes,
            "lookups": self.lookups,
            "hit_rate": self.hit_rate,
            "disk_hits": self.disk_hits,
            "disk_misses": self.disk_misses,
            "loads": self.loads,
            "load_failures": self.load_failures,
            "stores": self.stores,
            "token_disk_hits": self.token_disk_hits,
            "tuned_hits": self.tuned_hits,
            "tuned_misses": self.tuned_misses,
            "tuned_stores": self.tuned_stores,
            "chain_lookups": self.chain_lookups,
            **(
                {
                    "disk_dir": self.store.root,
                    "disk_files": len(self.store),
                    "disk_bytes": self.store.total_bytes(),
                    "disk_evictions": self.store.evictions,
                }
                if self.store is not None
                else {}
            ),
        }


class PlanCache:
    """Thread-safe LRU cache of built :class:`~repro_torch.spgemm.plan.SpGEMMPlan`.

    Keys are ``(pattern_hash, tile, group, backend, device, mesh_key)``
    tuples, suffixed ``"compact"`` for compact plans (``mesh_key`` is
    ``None`` for single-device plans; sharded plans pin the mesh axis,
    shard count, and device list, repeats included — see
    ``repro_torch.spgemm.plan._mesh_key``). ``get_or_build`` returns
    ``(plan, hit)`` so callers can attribute the lookup in their reports;
    ``stats``/``stats()`` expose live counters / a snapshot dict.

    Eviction is LRU under two caps: ``capacity`` (plan count) and, when set,
    ``max_bytes`` — a budget on the host memory the cached plans retain
    (each plan sized once at insert via its ``host_nbytes()``), so
    large-operand one-shot workloads cannot pin unbounded host memory. The
    most recently inserted plan is always kept, even when it alone exceeds
    the byte budget.

    ``disk_dir`` enables the disk tier (see the module docstring): memory
    misses try a verified :class:`~repro_torch.spgemm.persist.PlanStore` load
    before building, fresh builds are written back, and ``disk_max_bytes``
    bounds the directory (oldest-used files evicted after each save).

    Serving extras: ``token_get``/``token_bind`` maintain caller-supplied
    pattern-token aliases (the ``spgemm_plan(..., pattern_token=)`` fast
    path), and ``evict(key)`` drops one plan explicitly. Teardown is
    pipeline-safe — both explicit and LRU eviction refuse (raise / skip)
    plans with in-flight pipeline steps.
    """

    def __init__(
        self,
        capacity: int = 64,
        max_bytes: Optional[int] = None,
        disk_dir: Optional[str] = None,
        disk_max_bytes: Optional[int] = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be >= 1 (or None)")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.store = (
            PlanStore(disk_dir, max_bytes=disk_max_bytes)
            if disk_dir else None
        )
        self.stats = CacheStats(store=self.store)
        self._lock = threading.Lock()
        self._plans: OrderedDict = OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        # Pattern-token aliases: caller-supplied fast keys -> full plan
        # keys. An alias outlives its plan (a rebuilt plan under the same
        # full key revives it); lookups simply miss while the plan is out.
        self._tokens: dict = {}
        # Tuned-config sidecar records: tuned_key -> TunedConfig meta dict
        # (the memory tier above the PlanStore sidecar entries).
        self._tuned: dict = {}

    @property
    def total_bytes(self) -> int:
        """Bytes currently charged against ``max_bytes`` (insert-time
        sizes; a plan's later ``release_values()`` is not re-measured)."""
        with self._lock:
            return self._bytes

    @property
    def over_budget(self) -> bool:
        """True when resident plan bytes exceed ``max_bytes`` — possible
        because the newest plan is always kept and plans with in-flight
        pipeline steps are pinned against LRU eviction. Always False
        without a byte budget. This is the cache-pressure admission
        signal serving front ends (the gateway) shed on."""
        with self._lock:
            return self.max_bytes is not None and self._bytes > self.max_bytes

    def _plan_size(self, plan) -> int:
        size = getattr(plan, "host_nbytes", None)
        return int(size()) if callable(size) else 0

    def _drop(self, key) -> None:
        """Remove one entry (lock held)."""
        del self._plans[key]
        self._bytes -= self._sizes.pop(key, 0)
        self.stats.evictions += 1
        self._sync_resident()

    def _pop_lru(self) -> bool:
        """Evict the least-recently-used *evictable* plan (lock held).

        Plans with in-flight pipeline steps are skipped — their staged
        device buffers are still being read, so teardown must wait — and
        the most recently inserted plan is never evicted. Returns False
        when nothing is evictable (the caller stops; budgets are
        temporarily exceeded rather than corrupted)."""
        keys = list(self._plans)
        for key in keys[:-1]:  # never the just-inserted (newest) plan
            if getattr(self._plans[key], "in_flight", 0):
                continue
            self._drop(key)
            return True
        return False

    def _sync_resident(self) -> None:
        self.stats.resident_plans = len(self._plans)
        self.stats.resident_bytes = self._bytes

    def get_or_build(
        self,
        key: Tuple,
        builder: Callable,
        loader: Optional[Callable] = None,
    ):
        """Fetch or build the plan for ``key``; returns ``(plan, hit)``.

        ``hit`` is True only for memory-tier hits (the caller rebinds its
        values into the shared live object on that path). ``loader`` is the
        disk-tier rehydrator — ``loader(arrays, meta) -> plan`` — invoked
        on a memory miss when the disk tier holds a verified entry for
        ``key``; if it raises, the entry is treated as unusable and the
        plan is rebuilt from scratch (the store deletes files that fail
        verification itself). Loaded plans carry the caller's values
        already, so they return with ``hit=False``.
        """
        with self._lock:
            if key in self._plans:
                self.stats.hits += 1
                self._plans.move_to_end(key)
                return self._plans[key], True
            self.stats.misses += 1
        # Load / build outside the lock (the symbolic phase can be
        # expensive); a rare duplicate build under contention is benign —
        # last writer wins.
        plan = None
        if self.store is not None and loader is not None:
            payload = self.store.load(key)
            if payload is None:
                with self._lock:
                    self.stats.disk_misses += 1
            else:
                try:
                    plan = loader(*payload)
                    with self._lock:
                        self.stats.disk_hits += 1
                        self.stats.loads += 1
                except Exception:
                    # Verified file, unusable content (e.g. a future plan
                    # kind): fall back to a fresh symbolic build.
                    with self._lock:
                        self.stats.load_failures += 1
                    plan = None
        if plan is None:
            plan = builder()
            if self.store is not None:
                art = getattr(plan, "persist_artifacts", None)
                if callable(art):
                    try:
                        arrays, meta = art()
                        stored = self.store.save(key, arrays, meta)
                        if stored is not None:
                            with self._lock:
                                self.stats.stores += 1
                    except Exception:
                        pass  # persistence is an optimization, never fatal
        self._insert_plan(key, plan)
        return plan, False

    def _insert_plan(self, key: Tuple, plan) -> None:
        """Insert one plan under its full key (LRU + budget bookkeeping)."""
        size = self._plan_size(plan)
        # Back-reference for self-eviction: plan.release() uses this to
        # drop its own (now dead) entry so the key cannot keep serving a
        # released plan. Weak so the cache's lifetime is unaffected.
        try:
            plan._cache_ref = (weakref.ref(self), key)
        except AttributeError:  # pragma: no cover - exotic plan objects
            pass
        with self._lock:
            if key in self._plans:  # lost a build race: replace, re-charge
                self._bytes -= self._sizes.pop(key, 0)
            self._plans[key] = plan
            self._plans.move_to_end(key)
            self._sizes[key] = size
            self._bytes += size
            while len(self._plans) > self.capacity:
                if not self._pop_lru():
                    break
            if self.max_bytes is not None:
                while self._bytes > self.max_bytes and len(self._plans) > 1:
                    if not self._pop_lru():
                        break
            self._sync_resident()

    # -- pattern-token aliases (the serving warm path's fast key) ----------

    def token_get(self, token_key: Tuple):
        """Resolve a pattern-token alias to its live plan, or ``None``.

        A hit skips everything the digest path pays (``to_coo``,
        canonicalization, the pattern digest) — counted in
        ``stats.token_hits`` as well as ``stats.hits``. A miss (unknown
        token, or its plan was evicted) returns ``None`` and the caller
        falls back to the full digest path, which re-binds the alias."""
        with self._lock:
            key = self._tokens.get(token_key)
            if key is None or key not in self._plans:
                return None
            self.stats.hits += 1
            self.stats.token_hits += 1
            self._plans.move_to_end(key)
            return self._plans[key]

    def token_bind(self, token_key: Tuple, key: Tuple) -> None:
        """Bind a pattern token to a full plan key.

        A token is a caller's claim that two inputs share a sparsity
        pattern; binding validates it against the digest whenever both
        are present — re-binding a token to a *different* full key (a
        different pattern digest, tile, group, backend, or mesh) raises
        rather than silently serving the wrong plan.

        With the disk tier enabled, fresh bindings are also persisted in
        the store's token-alias index so a *restarted* worker resolves
        the token straight to a disk load (see :meth:`token_disk_get`)."""
        with self._lock:
            old = self._tokens.get(token_key)
            if old is not None and old != key:
                raise ValueError(
                    f"pattern token {token_key[1]!r} is already bound to a "
                    f"different plan key (pattern digest/config mismatch); "
                    f"tokens must uniquely name one sparsity pattern"
                )
            fresh = old is None
            self._tokens[token_key] = key
        if fresh and self.store is not None:
            self.store.alias_put(repr(token_key), repr(key))

    def token_disk_get(self, token_key: Tuple, loader: Callable):
        """Resolve a pattern-token alias through the store's persisted
        index — the warm-*restart* fast key, where the in-memory token
        map is gone but the alias (and usually the plan) survive on disk.

        Returns ``(plan, fresh)``:

        * ``(plan, True)`` — the aliased full key was rehydrated from
          disk via ``loader(key, arrays, meta)``; the plan already
          carries the caller's values and the alias was re-bound in
          memory. The whole resolution paid **no pattern digest** —
          counted in ``stats.token_disk_hits``.
        * ``(plan, False)`` — the aliased plan was still resident in
          memory under its full key (only the token map was cleared);
          the caller rebinds values exactly as for a ``token_get`` hit.
        * ``(None, False)`` — no disk tier, no alias, an unparseable or
          stale alias, or a failed load; the caller falls back to the
          digest path, which re-binds the alias.

        The alias is a *pointer*, never trusted content: the entry it
        names is still integrity-checked by the store and validated by
        the loader, so a lying or stale index degrades to a digest-path
        build, not a wrong plan.
        """
        if self.store is None:
            return None, False
        rep = self.store.alias_get(repr(token_key))
        if rep is None:
            return None, False
        try:
            key = ast.literal_eval(rep)
        except (ValueError, SyntaxError):
            return None, False
        if not isinstance(key, tuple):
            return None, False
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                # Resident under the full key (e.g. built digest-path
                # before this token was first presented): revive the
                # memory alias and serve as a token hit.
                self._tokens.setdefault(token_key, key)
                self.stats.hits += 1
                self.stats.token_hits += 1
                self.stats.token_disk_hits += 1
                self._plans.move_to_end(key)
                return plan, False
            self.stats.misses += 1
        payload = self.store.load(key)
        if payload is None:
            with self._lock:
                self.stats.disk_misses += 1
            return None, False
        try:
            plan = loader(key, *payload)
        except Exception:
            with self._lock:
                self.stats.load_failures += 1
            return None, False
        with self._lock:
            self.stats.disk_hits += 1
            self.stats.loads += 1
            self.stats.token_hits += 1
            self.stats.token_disk_hits += 1
            self._tokens.setdefault(token_key, key)
        self._insert_plan(key, plan)
        return plan, True

    # -- tuned-config sidecar (the autotuner's persistence tier) -----------

    @staticmethod
    def tuned_key(base_key: Tuple) -> Tuple:
        """The sidecar key for a plan key's tuned config. Namespaced so a
        tuned record can never collide with a plan artifact file."""
        return ("tuned",) + tuple(base_key)

    def tuned_get(self, base_key: Tuple) -> Optional[dict]:
        """The persisted tuned-config meta dict for ``base_key`` (memory
        first, then the disk sidecar), or ``None``: the autotuner's
        :class:`~repro_torch.spgemm.autotune.TunedConfig` record. A hit is
        what lets a warm restart apply the winning config with **zero**
        probe executions."""
        tkey = self.tuned_key(base_key)
        with self._lock:
            meta = self._tuned.get(tkey)
            if meta is not None:
                self.stats.tuned_hits += 1
                return dict(meta)
        if self.store is not None:
            payload = self.store.load(tkey)
            if payload is not None:
                meta = payload[1]
                with self._lock:
                    self._tuned[tkey] = dict(meta)
                    self.stats.tuned_hits += 1
                return dict(meta)
        with self._lock:
            self.stats.tuned_misses += 1
        return None

    def tuned_put(self, base_key: Tuple, meta: dict) -> None:
        """Record the winning config for ``base_key`` (memory + the disk
        sidecar when enabled). The sidecar record rides the same
        versioned/integrity-checked format as plan artifacts — an
        arrays-free entry whose header digest covers the meta dict."""
        tkey = self.tuned_key(base_key)
        with self._lock:
            self._tuned[tkey] = dict(meta)
        if self.store is not None:
            if self.store.save(tkey, {}, dict(meta)) is not None:
                with self._lock:
                    self.stats.tuned_stores += 1

    def evict(self, key: Tuple, only=None) -> bool:
        """Explicitly drop one plan from the memory tier.

        Returns False if the key is not resident. Raises RuntimeError if
        the plan has in-flight pipeline steps — its staged device buffers
        are still being read; collect or close the pipeline first.

        ``only`` pins identity: the entry is dropped only if the resident
        plan *is* that object (``SpGEMMPlan.release`` self-evicts with
        this, so releasing a stale plan whose key was since evicted and
        rebuilt can neither drop nor complain about the new live plan)."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is None or (only is not None and plan is not only):
                return False
            n = getattr(plan, "in_flight", 0)
            if n:
                raise RuntimeError(
                    f"cannot evict plan {key[0]!r}: {n} in-flight pipeline "
                    f"step(s); collect the tickets or close the pipeline "
                    f"first"
                )
            self._drop(key)
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def __contains__(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._plans

    def clear(self) -> None:
        """Drop the memory tier (disk entries, if any, are kept — they are
        exactly the state a restart would see)."""
        with self._lock:
            self._plans.clear()
            self._sizes.clear()
            self._tokens.clear()
            self._tuned.clear()
            self._bytes = 0
            self.stats = CacheStats(store=self.store)


_DEFAULT_CACHE: Optional[PlanCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> PlanCache:
    """The process-level cache used when no explicit cache is passed.

    Created lazily so ``REPRO_TORCH_SPGEMM_PLAN_DIR`` (set by the launcher
    before the first plan build) enables the disk tier without any code
    change — the warm-restart path for serving fleets."""
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        if _DEFAULT_CACHE is None:
            _DEFAULT_CACHE = PlanCache(
                disk_dir=os.environ.get(PLAN_DIR_ENV) or None
            )
        return _DEFAULT_CACHE
