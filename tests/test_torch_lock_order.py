"""Port parity: the lock-order lint (``repro_torch.analysis.locks``)
over the port's serving stack, as ``tests/test_lock_order.py`` checks
the JAX package's.

``instrument_spgemm_locks`` swaps the ``threading`` attribute of the
port's gateway/pipeline/cache/plan/persist modules for a recording shim,
so a scripted gateway workload built inside the ``with`` block (plans on
the CPU) reports every acquire/release to a :class:`LockOrderMonitor`.
The empirical graph must contain the known cross-layer edges and no
cycle; a synthetic inverted pair must be detected as a cycle. The cycle
detector is also held against the reference's on the same event
sequences.
"""
import threading

import pytest

pytest.importorskip("jax")

from repro.analysis.locks import LockOrderMonitor as R_LockOrderMonitor  # noqa: E402
from repro_torch.analysis.locks import (  # noqa: E402
    INSTRUMENTED_MODULES,
    LockOrderError,
    LockOrderMonitor,
    _InstrumentedLock,
    instrument_spgemm_locks,
)


class TestGatewayScenario:
    def test_serving_workload_is_acyclic(self):
        with instrument_spgemm_locks() as mon:
            from repro_torch.data.pipeline import SpGEMMValueStream
            from repro_torch.sparse.formats import COO
            from repro.sparse.random import random_coo
            from repro_torch.spgemm import PlanCache
            from repro_torch.spgemm.gateway import Outcome, SpGEMMGateway

            ra = random_coo(96, 72, 0.06, "uniform", seed=0).sum_duplicates()
            rb = random_coo(72, 80, 0.06, "uniform", seed=1).sum_duplicates()
            a = COO(ra.row, ra.col, ra.val, ra.shape)
            b = COO(rb.row, rb.col, rb.val, rb.shape)
            gw = SpGEMMGateway(cache=PlanCache(), max_pipelines=2, depth=2, max_batch=4)
            try:
                plan = gw.register("lint/p", a, b, tile=8, group=2, device="cpu")
                stream = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
                tickets = [gw.submit("lint/p", *stream.values_at(s)) for s in range(6)]
                results = [t.wait(timeout=120) for t in tickets]
            finally:
                gw.close()
        assert all(r.outcome is Outcome.OK for r in results)
        sites = mon.sites()
        assert sites, "no instrumented locks were constructed"
        assert any("gateway.py" in s for s in sites)
        # The known cross-layer ordering: gateway -> pipeline -> plan.
        edges = mon.edges()
        flat = {(src, dst) for src, dsts in edges.items() for dst in dsts}
        assert any("pipeline.py" in s and "plan.py" in d for s, d in flat), \
            f"expected the submit path's pipeline->plan edge, got {flat}"
        findings = mon.check()  # must not raise: the graph is acyclic
        assert not [f for f in findings if f.severity == "error"]

    def test_instrumentation_restores_threading(self):
        import repro_torch.spgemm.gateway as gwmod

        before = gwmod.threading
        with instrument_spgemm_locks():
            assert gwmod.threading is not before
        assert gwmod.threading is before
        assert gwmod.threading is threading

    def test_instruments_the_ports_modules_only(self):
        assert INSTRUMENTED_MODULES == tuple(
            f"repro_torch.spgemm.{m}" for m in ("gateway", "pipeline", "cache", "plan",
                                                 "persist"))
        import repro.spgemm.gateway as r_gwmod

        with instrument_spgemm_locks():
            assert r_gwmod.threading is threading

    def test_the_cli_lock_lint(self):
        from repro_torch.analysis.check import lock_lint

        failures = []
        info = lock_lint(failures, device="cpu")
        assert failures == [] and info["requests"] == 12 and info["sites"] >= 3
        assert any("pipeline.py" in s and any("plan.py" in d for d in dsts)
                   for s, dsts in info["edges"].items())


def _replay(mon, events):
    """Replay ``(thread, op, site)`` events, each thread's in order, one
    thread after another."""
    by_thread = {}
    for th, op, site in events:
        by_thread.setdefault(th, []).append((op, site))
    for ops in by_thread.values():
        def run(ops=ops):
            for op, site in ops:
                (mon._on_acquire if op == "+" else mon._on_release)(site)

        t = threading.Thread(target=run)
        t.start()
        t.join()


class TestCycleDetection:
    def test_inverted_order_is_a_cycle(self):
        """Two threads taking the same pair of lock sites in opposite
        orders — the canonical ABBA deadlock — must be reported."""
        events = [(1, "+", "a.py:1"), (1, "+", "b.py:2"), (1, "-", "b.py:2"),
                  (1, "-", "a.py:1"), (2, "+", "b.py:2"), (2, "+", "a.py:1"),
                  (2, "-", "a.py:1"), (2, "-", "b.py:2")]
        mon, ref = LockOrderMonitor(), R_LockOrderMonitor()
        _replay(mon, events)
        _replay(ref, events)
        cycle = mon.find_cycle()
        assert cycle is not None and cycle == ref.find_cycle()
        assert set(cycle) >= {"a.py:1", "b.py:2"}
        with pytest.raises(LockOrderError, match="lock-order cycle"):
            mon.check()

    def test_three_site_cycle(self):
        events = []
        for th, (x, y) in enumerate([("x:1", "y:2"), ("y:2", "z:3"), ("z:3", "x:1")]):
            events += [(th, "+", x), (th, "+", y), (th, "-", y), (th, "-", x)]
        mon, ref = LockOrderMonitor(), R_LockOrderMonitor()
        _replay(mon, events)
        _replay(ref, events)
        assert mon.find_cycle() is not None and mon.find_cycle() == ref.find_cycle()

    def test_same_site_nesting_is_warning_not_error(self):
        mon = LockOrderMonitor()
        mon._on_acquire("p.py:9")
        mon._on_acquire("p.py:9")  # second *instance* of the same site
        mon._on_release("p.py:9")
        mon._on_release("p.py:9")
        findings = mon.check()  # no cycle -> no raise
        assert [f.check for f in findings] == ["locks.self-nesting"]

    def test_acyclic_graph_clean(self):
        mon = LockOrderMonitor()
        mon._on_acquire("a:1")
        mon._on_acquire("b:2")
        mon._on_release("b:2")
        mon._on_release("a:1")
        assert mon.find_cycle() is None
        assert mon.check() == []


class TestInstrumentedLockSemantics:
    def test_condition_wait_releases_hold(self):
        """threading.Condition over the wrapper must report the lock as
        *released* while waiting (otherwise every producer/consumer pair
        would look like a self-deadlock)."""
        mon = LockOrderMonitor()
        lk = _InstrumentedLock(threading.Lock(), mon, "w.py:1")
        cond = threading.Condition(lk)
        hits = []

        def waiter():
            with cond:
                cond.wait(timeout=30)
                mon._on_acquire("w.py:2")
                mon._on_release("w.py:2")
                hits.append(True)

        th = threading.Thread(target=waiter)
        th.start()
        for _ in range(1000):
            with cond:
                cond.notify_all()
            if hits:
                break
        th.join(timeout=30)
        assert hits
        assert ("w.py:1", frozenset({"w.py:2"})) in [
            (s, frozenset(d)) for s, d in mon.edges().items()
        ]
        assert mon.find_cycle() is None

    def test_nonblocking_acquire_failure_not_recorded(self):
        mon = LockOrderMonitor()
        inner = threading.Lock()
        lk = _InstrumentedLock(inner, mon, "n.py:1")
        inner.acquire()  # someone else holds it
        try:
            assert lk.acquire(False) is False
        finally:
            inner.release()
        assert mon._held() == []
        assert lk.acquire(False) is True
        lk.release()
        assert mon.sites() == {"n.py:1"}
