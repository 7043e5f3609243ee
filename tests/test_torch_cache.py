"""Port parity: the memory tier of ``repro_torch``'s plan cache
(``spgemm/cache.py``'s :class:`PlanCache`) and the cache half of
``spgemm_plan``, on the CPU, against the JAX package.

The semantics follow ``tests/test_spgemm_plan.py``'s cache and pattern
token tests and ``tests/test_pipeline.py``'s release guards: a hit
returns the same plan object with this call's values rebound; keys
separate pattern, value dtype, tile, group, backend, device, mesh and
output mode; the LRU and the byte budget skip plans with pipeline steps in
flight; ``release()`` evicts its plan; the pattern token skips the digest
and refuses to serve a different pattern or value dtype. The counters of
a sequence of calls equal the reference's for the same sequence.
"""
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.core.gustavson import spgemm_gustavson  # noqa: E402
from repro_torch.data.pipeline import SpGEMMValueStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.sparse.convert import to_bcsr, to_bcsv, to_csr  # noqa: E402
from repro_torch.sparse.formats import BCSR, BCSV, COO  # noqa: E402
from repro_torch.sparse.random import random_block_sparse  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    PlanCache,
    default_cache,
    plan_from_structural_pattern,
    schedule_build_count,
    spgemm_plan,
)
from repro_torch.spgemm import cache as cache_mod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers side by side, and many threads per worker contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int_coo(m, n, density, seed):
    """A COO for both packages with small-integer float32 values."""
    coo = r_random_coo(m, n, density, "uniform", seed=seed)
    rng = np.random.default_rng(seed + 999)
    vals = rng.integers(-4, 5, coo.nnz).astype(np.float32)
    coo.val = np.where(vals == 0, np.float32(1.0), vals)
    return COO(coo.row, coo.col, coo.val, coo.shape), R_COO(coo.row, coo.col, coo.val,
                                                             coo.shape)


def _pc(seed, m=48, n=40, density=0.12):
    return _int_coo(m, n, density, seed)[0]


def _plan(a, b, cache, **kw):
    kw.setdefault("tile", 8)
    kw.setdefault("group", 2)
    return spgemm_plan(a, b, device="cpu", cache=cache, **kw)


def _oracle(a, b):
    return spgemm_gustavson(to_csr(a.sum_duplicates()), to_csr(b.sum_duplicates())).todense()


# -- hits, misses, LRU, byte budget ----------------------------------------------

def test_hit_returns_the_same_plan_with_this_calls_values():
    a, b = _pc(21, 64, 48, 0.1), _pc(22, 48, 64, 0.1)
    cache = PlanCache()
    p1 = _plan(a, b, cache, tile=16)
    builds = schedule_build_count()
    a2 = COO(a.row, a.col, a.val * 2.0, a.shape)
    p2 = _plan(a2, b, cache, tile=16)
    assert p2 is p1 and schedule_build_count() == builds
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    assert p1.report.cache_hits == 1 and p1.report.cache_stats["hits"] == 1
    assert np.array_equal(p2.execute().todense(), _oracle(a2, b))


def test_misses_on_pattern_dtype_params_device_mesh_and_output():
    a, b = _pc(31, 64, 48, 0.1), _pc(32, 48, 64, 0.1)
    cache = PlanCache()
    plans = [
        _plan(a, b, cache, tile=16),
        _plan(a, b, cache, tile=8),
        _plan(a, b, cache, tile=16, group=4),
        _plan(a, b, cache, tile=16, output="compact"),
        _plan(a, b, cache, tile=16, mesh=make_shard_mesh(2, devices=["cpu"] * 2)),
        _plan(a, b, cache, tile=16, mesh=make_shard_mesh(3, devices=["cpu"] * 3)),
        _plan(COO(a.row, a.col, a.val.astype(np.float64), a.shape), b, cache, tile=16),
    ]
    assert len({id(p) for p in plans}) == len(plans)
    assert cache.stats.misses == len(plans) and cache.stats.hits == 0
    keys = list(cache._plans)
    assert {k[3] for k in keys} == {"torch"} and {k[4] for k in keys} == {"cpu"}
    assert (("shard", 2, ("cpu", "cpu")) in {k[5] for k in keys})
    assert _plan(a, b, cache, tile=16, mesh=make_shard_mesh(2, devices=["cpu"] * 2)) \
        is plans[4]


def test_lru_capacity_and_byte_budget():
    cache = PlanCache(capacity=2)
    p1 = _plan(_pc(1), _pc(2, 40, 48), cache)
    _plan(_pc(3), _pc(4, 40, 48), cache)
    _plan(_pc(1), _pc(2, 40, 48), cache)  # p1 is now the most recent
    _plan(_pc(5), _pc(6, 40, 48), cache)  # evicts the second
    assert len(cache) == 2 and cache.stats.evictions == 1
    assert any(p is p1 for p in cache._plans.values())
    one = p1.host_nbytes()
    budget = PlanCache(max_bytes=one + one // 2)
    q1 = _plan(_pc(1), _pc(2, 40, 48), budget)
    _plan(_pc(3), _pc(4, 40, 48), budget)
    assert len(budget) == 1 and all(p is not q1 for p in budget._plans.values())
    assert not budget.over_budget
    tiny = PlanCache(max_bytes=1)
    _plan(_pc(1), _pc(2, 40, 48), tiny)  # the newest plan is always kept
    assert len(tiny) == 1 and tiny.over_budget and tiny.total_bytes > 1


def test_stats_match_the_reference_for_one_sequence():
    """One sequence of calls (hits, misses, a compact key, tokens, an LRU
    eviction) leaves the port's counters where the reference's are."""
    seq = [(11, 8, "block", None), (11, 8, "block", None), (12, 8, "block", "t"),
           (11, 8, "compact", None), (12, 8, "block", "t"), (11, 16, "block", None),
           (11, 8, "block", None), (13, 8, "block", None)]
    mats = {s: (_int_coo(48, 40, 0.12, s), _int_coo(40, 48, 0.12, s + 100))
            for s in (11, 12, 13)}
    got, want = PlanCache(capacity=3), R_PlanCache(capacity=3)
    for seed, tile, output, token in seq:
        (pa, ra), (pb, rb) = mats[seed]
        _plan(pa, pb, got, tile=tile, output=output, pattern_token=token)
        r_spgemm_plan(ra, rb, tile=tile, group=2, backend="jnp", cache=want, output=output,
                      pattern_token=token)
    g, w = got.stats(), want.stats()
    for k in ("hits", "misses", "token_hits", "evictions", "resident_plans", "lookups"):
        assert g[k] == w[k], (k, g[k], w[k])


def test_concurrent_executes_on_a_shared_plan():
    a, b = _pc(81, 40, 30), _pc(82, 30, 40)
    plan = _plan(a, b, PlanCache())
    bad = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        av = rng.integers(-3, 4, a.nnz).astype(np.float32)
        bv = rng.integers(-3, 4, b.nnz).astype(np.float32)
        c = plan.execute(av, bv)
        want = _oracle(COO(plan.a_pattern.row, plan.a_pattern.col, av, a.shape),
                       COO(plan.b_pattern.row, plan.b_pattern.col, bv, b.shape))
        if not np.array_equal(c.todense(), want):
            bad.append(seed)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad and plan.report.executes == 8


def test_threads_share_one_cache_under_pressure():
    """More threads than cores build, hit, execute, release and evict on
    one small cache with a short switch interval: no error, no deadlock
    (cache lock before plan lock, always), every lookup counted, and
    every result equals the oracle."""
    import os
    import sys

    mats = [(_pc(200 + i, 40, 32, 0.15), _pc(300 + i, 32, 40, 0.15)) for i in range(4)]
    want = [_oracle(a, b) for a, b in mats]
    cache = PlanCache(capacity=2)
    errors, calls = [], [0]
    lock = threading.Lock()

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(6):
                i = int(rng.integers(len(mats)))
                plan = _plan(*mats[i], cache)
                with lock:
                    calls[0] += 1
                got = plan.execute(plan.a_pattern.val, plan.b_pattern.val)
                if not np.array_equal(got.todense(), want[i]):
                    errors.append(f"wrong result for pattern {i}")
                if rng.random() < 0.2:
                    try:
                        plan.release()
                    except RuntimeError:
                        pass  # another thread's pipeline step was in flight
        except RuntimeError as e:  # a plan another thread released
            if "released" not in str(e):
                errors.append(repr(e))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a thread hung"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert cache.stats.lookups == calls[0] and len(cache) <= 2


class _ReleaseAfterUnlock:
    """Stands in for a plan's lock: once armed, the first time a numeric
    entry leaves its locked block, another thread calls ``plan.release()``
    (and is joined) before the entry goes on. That is the window in which
    ``release()`` clears the plan's executor."""

    def __init__(self, plan):
        self._lock, self._plan = plan._lock, plan
        self.armed = False
        self.released = False

    def acquire(self, *args, **kwargs):
        return self._lock.acquire(*args, **kwargs)

    def release(self):
        self._lock.release()
        if self.armed:
            self.armed = False
            t = threading.Thread(target=self._plan.release)
            t.start()
            t.join(timeout=60)
            self.released = self._plan._released

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


@pytest.mark.parametrize("entry", ["execute", "execute_noarg", "execute_batch", "chained",
                                   "submit"])
def test_release_racing_an_execute_never_returns_an_empty_result(entry):
    """A ``release()`` that lands between a numeric entry's locked block
    and its numeric work: the entry returns the oracle's C (it runs on the
    executor it took under the lock) or raises the plan's "released"
    error; never an empty CSR, never an AttributeError."""
    a, b = _pc(41, 40, 32, 0.15), _pc(42, 32, 40, 0.15)
    want = _oracle(a, b)
    if entry == "chained":
        first = _plan(a, b, PlanCache(), output="compact")
        b2 = _pc(43, 40, 24, 0.2)
        chain = first.then(b2, cache=PlanCache())
        plan, want = chain.plans[1], _oracle(a, b) @ b2.todense()
    else:
        plan = _plan(a, b, PlanCache())
    guard = _ReleaseAfterUnlock(plan)
    plan._lock = guard
    guard.armed = True
    try:
        if entry == "execute":
            got = [plan.execute(a.val, b.val)]
        elif entry == "execute_noarg":
            got = [plan.execute()]
        elif entry == "execute_batch":
            got = plan.execute_batch(np.stack([a.val] * 2), np.stack([b.val] * 2))
        elif entry == "chained":
            got = [chain.execute(a.val, b.val)]
        else:
            got = [plan.pipeline(depth=1).submit(a.val, b.val).result()]
    except RuntimeError as e:
        assert "released" in str(e), e
        got = None
    assert guard.released and not guard.armed
    if got is not None:
        for c in got:
            assert c.nnz > 0 and np.array_equal(c.todense(), want)
    with pytest.raises(RuntimeError, match="released"):
        plan.execute(a.val, b.val)


# -- pattern tokens ------------------------------------------------------------------

def test_token_hit_skips_digest_and_rebinds_values(monkeypatch):
    cache = PlanCache()
    a, b = _pc(11, 64, 48, 0.1), _pc(12, 48, 64, 0.1)
    plan = _plan(a, b, cache, tile=16, pattern_token="layer0")
    assert plan.report.as_dict()["pattern_token"] == "layer0"
    from repro_torch.spgemm import plan as plan_mod

    def boom(*_a, **_k):
        raise AssertionError("a token hit paid the pattern digest")

    monkeypatch.setattr(plan_mod, "pattern_digest", boom)
    a2 = COO(a.row, a.col, a.val * 3.0, a.shape)
    b2 = COO(b.row, b.col, b.val * 0.5, b.shape)
    assert _plan(a2, b2, cache, tile=16, pattern_token="layer0") is plan
    assert cache.stats.token_hits == 1 and plan.report.cache_hits == 1
    assert np.allclose(plan.execute().todense(), _oracle(a2, b2))
    rng = np.random.default_rng(0)
    pa, pb = rng.permutation(a.nnz), rng.permutation(b.nnz)
    shuffled = (COO(a.row[pa], a.col[pa], a.val[pa], a.shape),
                COO(b.row[pb], b.col[pb], b.val[pb], b.shape))
    assert _plan(*shuffled, cache, tile=16, pattern_token="layer0") is plan
    assert np.array_equal(plan.execute().todense(), _oracle(a, b))


def test_token_pure_lookup_scopes_and_eviction():
    cache = PlanCache(capacity=1)
    a, b = _pc(31, 32, 32, 0.15), _pc(32, 32, 32, 0.15)
    with pytest.raises(KeyError, match="not resident"):
        _plan(None, None, cache, tile=16, pattern_token="missing")
    p16 = _plan(a, b, cache, tile=16, pattern_token="tok")
    assert _plan(None, None, cache, tile=16, pattern_token="tok") is p16
    p8 = _plan(a, b, cache, tile=8, pattern_token="tok")  # evicts p16 (capacity 1)
    assert p8 is not p16
    assert _plan(None, None, cache, tile=8, pattern_token="tok") is p8
    with pytest.raises(KeyError):
        _plan(None, None, cache, tile=16, pattern_token="tok")
    p = _plan(a, b, cache, tile=16, pattern_token="tok")  # the digest path rebinds
    assert _plan(None, None, cache, tile=16, pattern_token="tok") is p


def test_token_conflicts_raise():
    """A token bound to one pattern refuses another pattern, another
    element count, another value dtype and an input type it cannot
    rebind."""
    cache = PlanCache(capacity=1)
    a, b = _pc(41, 32, 32, 0.15), _pc(42, 32, 32, 0.15)
    _plan(a, b, cache, tile=16, pattern_token="tok")
    a2, b2 = _pc(43, 32, 32, 0.2), _pc(44, 32, 32, 0.2)
    _plan(a2, b2, cache, tile=16)  # evicts the aliased plan
    with pytest.raises(ValueError, match="already bound"):
        _plan(a2, b2, cache, tile=16, pattern_token="tok")
    cache = PlanCache()
    a, b = _pc(81), _pc(82, 40, 48)
    p32 = _plan(a, b, cache, pattern_token="tok")
    with pytest.raises(ValueError, match="does not match the token"):
        _plan(COO(a.row[:-1], a.col[:-1], a.val[:-1], a.shape), b, cache, pattern_token="tok")
    a64 = COO(a.row, a.col, a.val.astype(np.float64), a.shape)
    b64 = COO(b.row, b.col, b.val.astype(np.float64), b.shape)
    with pytest.raises(ValueError, match="already bound"):
        _plan(a64, b64, cache, pattern_token="tok")
    assert _plan(a64, b64, cache) is not p32
    with pytest.raises(ValueError, match="token fast path"):
        _plan(to_csr(a), to_csr(b), cache, pattern_token="tok")


def test_token_hit_rebinds_block_inputs():
    cache = PlanCache()
    d_a = random_block_sparse(64, 64, (16, 16), 0.4, seed=71)
    d_b = random_block_sparse(64, 64, (16, 16), 0.4, seed=72)
    a1, b1 = to_bcsv(d_a, (16, 16), 2), to_bcsr(d_b, (16, 16))
    plan = spgemm_plan(a1, b1, device="cpu", cache=cache, pattern_token="blk")
    a2 = BCSV(a1.blocks * 2.0, a1.brow, a1.bcol, a1.group_ptr, a1.shape, a1.group)
    b2 = BCSR(b1.indptr, b1.indices, b1.blocks * 0.5, b1.shape)
    assert spgemm_plan(a2, b2, device="cpu", cache=cache, pattern_token="blk") is plan
    np.testing.assert_allclose(plan.execute().todense(), (d_a * 2.0) @ (d_b * 0.5),
                               rtol=1e-5, atol=1e-4)
    # A digest-path hit with block inputs rebinds too.
    assert spgemm_plan(a1, b1, device="cpu", cache=cache) is plan
    np.testing.assert_allclose(plan.execute().todense(), d_a @ d_b, rtol=1e-5, atol=1e-4)


# -- release and the in-flight guards ---------------------------------------------

def test_release_evicts_and_a_stale_release_leaves_the_rebuilt_plan():
    cache = PlanCache()
    a, b = _pc(95), _pc(96, 40, 48)
    plan = _plan(a, b, cache)
    plan.release()
    assert len(cache) == 0
    p2 = _plan(a, b, cache)
    assert p2 is not plan
    p2.execute()
    cache = PlanCache(capacity=1)
    old = _plan(a, b, cache)
    _plan(_pc(87), _pc(88, 40, 48), cache)
    fresh = _plan(a, b, cache)  # rebuilt under old's key
    assert fresh is not old
    old.release()
    assert len(cache) == 1 and _plan(a, b, cache) is fresh


def test_cache_evict_guard():
    cache = PlanCache()
    plan = _plan(_pc(151), _pc(152, 40, 48), cache)
    stream = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=2)
    (key,) = list(cache._plans)
    t = plan.pipeline(depth=1).submit(*stream.values_at(0))
    with pytest.raises(RuntimeError, match="in-flight pipeline"):
        cache.evict(key)
    with pytest.raises(RuntimeError, match="in-flight pipeline"):
        plan.release()
    assert key in cache
    t.result()
    assert cache.evict(key) and key not in cache
    assert not cache.evict(key)


def test_lru_eviction_skips_in_flight_plans():
    cache = PlanCache(capacity=2)
    p1 = _plan(_pc(161), _pc(162, 40, 48), cache)
    stream = SpGEMMValueStream(p1.a_pattern, p1.b_pattern, seed=2)
    t = p1.pipeline(depth=1).submit(*stream.values_at(0))
    p2 = _plan(_pc(163), _pc(164, 40, 48), cache)
    _plan(_pc(165), _pc(166, 40, 48), cache)  # would evict p1 (LRU)
    resident = list(cache._plans.values())
    assert any(p is p1 for p in resident) and all(p is not p2 for p in resident)
    t.result()


def test_chained_plan_cache_hit_and_counter():
    cache = PlanCache()
    a, b, c = _pc(44, 64, 56, 0.07), _pc(45, 56, 48, 0.07), _pc(46, 48, 40, 0.07)
    p1 = _plan(a, b, cache, output="compact")
    pat = p1.output_pattern()
    q1 = plan_from_structural_pattern(pat, c, tile=8, group=2, device="cpu", cache=cache,
                                      output="compact")
    q2 = plan_from_structural_pattern(pat, c, tile=8, group=2, device="cpu", cache=cache,
                                      output="compact")
    assert q2 is q1 and q1.report.cache_hits == 1
    assert cache.stats.chain_lookups == 2 and cache.stats()["chain_lookups"] == 2
    assert p1.then(c, cache=cache).plans[1] is q1


# -- ops.spgemm, the default cache, the tuned sidecar --------------------------------

def test_ops_spgemm_goes_through_the_cache_with_fresh_values():
    ad = random_block_sparse(128, 128, (32, 32), 0.4, seed=41)
    bd = random_block_sparse(128, 128, (32, 32), 0.4, seed=42)
    cache = PlanCache()
    c1 = ops.spgemm(to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32)), device="cpu", cache=cache)
    np.testing.assert_allclose(c1.todense(), ad.astype(np.float64) @ bd, rtol=1e-4, atol=1e-4)
    ad2 = (ad * 3.0).astype(np.float32)
    builds = schedule_build_count()
    c2 = ops.spgemm(to_bcsv(ad2, (32, 32), 2), to_bcsr(bd, (32, 32)), device="cpu", cache=cache)
    assert schedule_build_count() == builds and cache.stats.hits == 1
    np.testing.assert_allclose(c2.todense(), ad2.astype(np.float64) @ bd, rtol=1e-4, atol=1e-4)
    (plan,) = cache._plans.values()
    assert plan._a_dev is None and plan._b_dev is None  # device copies released


def test_ops_spgemm_keeps_direct_plan_holders_working():
    ad = random_block_sparse(96, 96, (32, 32), 0.5, seed=101)
    bd = random_block_sparse(96, 96, (32, 32), 0.5, seed=102)
    a, b = to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32))
    p = spgemm_plan(a, b, device="cpu")  # the process-level cache
    ops.spgemm(a, b, device="cpu")
    assert default_cache().stats.hits >= 1
    np.testing.assert_allclose(p.execute().todense(), ad.astype(np.float64) @ bd,
                               rtol=1e-4, atol=1e-4)
    p.release()


def test_default_cache_reads_the_plan_dir_env(tmp_path, monkeypatch):
    monkeypatch.setattr(cache_mod, "_DEFAULT_CACHE", None)
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PLAN_DIR", str(tmp_path))
    cache = default_cache()
    assert cache is default_cache() and cache.store.root == str(tmp_path)
    monkeypatch.setattr(cache_mod, "_DEFAULT_CACHE", None)


def test_tuned_sidecar_and_clear(tmp_path):
    cache = PlanCache(disk_dir=str(tmp_path))
    key = ("pat", (8, 8, 8), 2, "torch", "cpu", None)
    assert cache.tuned_get(key) is None
    cache.tuned_put(key, {"chunk_bytes": 1 << 20, "pipeline_depth": 2})
    assert PlanCache(disk_dir=str(tmp_path)).tuned_get(key) == {
        "chunk_bytes": 1 << 20, "pipeline_depth": 2}
    s = cache.stats()
    assert s["tuned_misses"] == 1 and s["tuned_stores"] == 1
    _plan(_pc(1), _pc(2, 40, 48), cache)
    cache.clear()
    assert len(cache) == 0 and cache.stats.hits == 0 and len(cache.store) == 2
    with pytest.raises(ValueError):
        PlanCache(capacity=0)
    with pytest.raises(TypeError, match="PlanCache"):
        _plan(_pc(1), _pc(2, 40, 48), object())
