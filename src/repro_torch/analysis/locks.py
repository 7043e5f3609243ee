"""Lock-order deadlock lint for the serving stack (the port of the JAX
package's ``analysis/locks.py``, over the port's modules).

The gateway/pipeline/cache/plan layers each own locks and call across
layers while holding them (e.g. ``SpGEMMPipeline.submit`` acquires
``plan._lock`` under ``pipeline._lock``). A deadlock needs a *cycle* in
the lock-acquisition order; this module records that order empirically
and fails on cycles:

* :class:`LockOrderMonitor` — the acquisition-graph recorder. Locks are
  identified by their **creation site** (``file:line``), so every
  ``plan._lock`` instance maps to one graph node; an edge ``A -> B``
  means some thread acquired a ``B``-site lock while holding an
  ``A``-site lock.
* :func:`instrument_spgemm_locks` — a context manager that swaps the
  ``threading`` module attribute of ``repro_torch.spgemm``'s gateway,
  pipeline, cache, plan, and persist modules for a recording shim, so
  every lock those modules construct *while instrumented* reports to the
  monitor. Existing locks are untouched — construct the objects under
  test inside the ``with`` block.
* :meth:`LockOrderMonitor.check` — cycle detection over the site graph.
  A cycle between distinct sites is an ``error`` (two threads can
  interleave into a deadlock); two *instances* of the same site nested
  (plan-lock under plan-lock, say) is a ``warning`` — safe only under an
  instance ordering the graph cannot see.

Typical use (the CLI's ``--lock-lint``)::

    with instrument_spgemm_locks() as mon:
        ... build a gateway, submit, collect, close ...
    mon.check()   # raises LockOrderError on a cycle
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.verify import Finding

__all__ = [
    "LockOrderError",
    "LockOrderMonitor",
    "instrument_spgemm_locks",
]

# The serving-stack modules whose lock construction gets instrumented.
INSTRUMENTED_MODULES = (
    "repro_torch.spgemm.gateway",
    "repro_torch.spgemm.pipeline",
    "repro_torch.spgemm.cache",
    "repro_torch.spgemm.plan",
    "repro_torch.spgemm.persist",
)


class LockOrderError(AssertionError):
    """The recorded lock-acquisition graph contains a cycle."""


class _InstrumentedLock:
    """A ``threading.Lock``/``RLock`` proxy that reports acquire/release
    to the monitor. Duck-compatible with ``threading.Condition(lock)``
    (which only needs ``acquire``/``release`` and context management)."""

    __slots__ = ("_lock", "_monitor", "site")

    def __init__(self, lock, monitor: "LockOrderMonitor", site: str):
        self._lock = lock
        self._monitor = monitor
        self.site = site

    def acquire(self, *args, **kwargs):
        blocking = args[0] if args else kwargs.get("blocking", True)
        if blocking:
            # Record *intent* before a blocking acquire: a deadlocked
            # acquire would otherwise never be observed at all.
            self._monitor._on_acquire(self.site)
            got = self._lock.acquire(*args, **kwargs)
            if not got:  # timed out
                self._monitor._on_release(self.site)
            return got
        got = self._lock.acquire(*args, **kwargs)
        if got:
            self._monitor._on_acquire(self.site)
        return got

    def release(self):
        self._monitor._on_release(self.site)
        return self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()


class _ThreadingShim:
    """Stands in for a module's ``threading`` attribute: ``Lock()`` /
    ``RLock()`` return instrumented wrappers named by their creation
    site; everything else proxies to the real module."""

    def __init__(self, monitor: "LockOrderMonitor", modname: str):
        self._monitor = monitor
        self._modname = modname

    def _site(self) -> str:
        frame = sys._getframe(2)
        short = self._modname.rsplit(".", 1)[-1]
        return f"{short}.py:{frame.f_lineno}"

    def Lock(self):  # noqa: N802 - mirrors threading.Lock
        return _InstrumentedLock(
            threading.Lock(), self._monitor, self._site()
        )

    def RLock(self):  # noqa: N802 - mirrors threading.RLock
        return _InstrumentedLock(
            threading.RLock(), self._monitor, self._site()
        )

    def Condition(self, lock=None):  # noqa: N802 - mirrors threading
        # threading.Condition works against the wrapper's acquire/release
        # (its _is_owned / _release_save fallbacks), so wait/notify keep
        # reporting hold state correctly through the proxy.
        if lock is None:
            lock = self.Lock()
        return threading.Condition(lock)

    def __getattr__(self, name):
        return getattr(threading, name)


class LockOrderMonitor:
    """Records which lock *sites* are held when each site is acquired."""

    def __init__(self):
        self._graph_lock = threading.Lock()
        # site -> set of sites acquired while it was held (A -> B edges).
        self._edges: Dict[str, Set[str]] = {}
        self._sites: Set[str] = set()
        # Same-site nesting across distinct instances (warning class).
        self._self_nested: Set[str] = set()
        self._tls = threading.local()

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _on_acquire(self, site: str) -> None:
        held = self._held()
        with self._graph_lock:
            self._sites.add(site)
            for h in held:
                if h == site:
                    self._self_nested.add(site)
                else:
                    self._edges.setdefault(h, set()).add(site)
        held.append(site)

    def _on_release(self, site: str) -> None:
        held = self._held()
        # Remove the innermost matching hold (locks are typically — but
        # not necessarily — released LIFO).
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                return

    def edges(self) -> Dict[str, Set[str]]:
        with self._graph_lock:
            return {k: set(v) for k, v in self._edges.items()}

    def sites(self) -> Set[str]:
        with self._graph_lock:
            return set(self._sites)

    def find_cycle(self) -> Optional[List[str]]:
        """A site cycle in the acquisition graph, or None."""
        edges = self.edges()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {s: WHITE for s in set(edges) | {
            t for vs in edges.values() for t in vs
        }}
        parent: Dict[str, Optional[str]] = {}

        def dfs(u: str) -> Optional[Tuple[str, str]]:
            color[u] = GRAY
            for v in sorted(edges.get(u, ())):
                if color[v] == GRAY:
                    return (u, v)
                if color[v] == WHITE:
                    parent[v] = u
                    back = dfs(v)
                    if back is not None:
                        return back
            color[u] = BLACK
            return None

        for s in sorted(color):
            if color[s] == WHITE:
                parent[s] = None
                back = dfs(s)
                if back is not None:
                    u, v = back
                    cycle = [v, u]
                    while cycle[-1] != v and parent.get(cycle[-1]):
                        cycle.append(parent[cycle[-1]])
                    return list(reversed(cycle))
        return None

    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        cycle = self.find_cycle()
        if cycle is not None:
            out.append(Finding(
                check="locks.cycle", severity="error",
                message="lock-order cycle: " + " -> ".join(cycle),
            ))
        with self._graph_lock:
            for site in sorted(self._self_nested):
                out.append(Finding(
                    check="locks.self-nesting", severity="warning",
                    message=f"two instances of {site} nested; safe only "
                            f"under a consistent instance order",
                ))
        return out

    def check(self) -> List[Finding]:
        """Raise :class:`LockOrderError` on a cycle; return findings."""
        found = self.findings()
        for f in found:
            if f.severity == "error":
                raise LockOrderError(f.message)
        return found


@contextlib.contextmanager
def instrument_spgemm_locks(modules: Tuple[str, ...] = INSTRUMENTED_MODULES):
    """Swap the serving modules' ``threading`` attribute for a recording
    shim; yields the :class:`LockOrderMonitor`. Only locks constructed
    inside the ``with`` block are recorded."""
    import importlib

    monitor = LockOrderMonitor()
    saved = []
    try:
        for name in modules:
            mod = importlib.import_module(name)
            saved.append((mod, mod.threading))
            mod.threading = _ThreadingShim(monitor, name)
        yield monitor
    finally:
        for mod, original in saved:
            mod.threading = original
