"""Port parity: the multi-tenant serving gateway (``spgemm/gateway.py``) on
the CPU.

* **Against the reference.** A ``start=False`` scenario (queue bound, byte
  budget, cache pressure, close without drain, a submit after close)
  resolves the same tickets to the same typed outcomes in the same order
  as the JAX package's gateway; small-integer results served by the port's
  gateway are bitwise equal to the reference plan's ``execute``.
* **Inside the port** (the invariants of ``tests/test_gateway.py``): every
  result is bitwise equal to a direct ``plan.execute`` of its values,
  however it was micro-batched; overload is typed and never hangs; a hot
  tenant cannot starve a cold one; pool eviction never tears down a
  pipeline with a ticket in flight; concurrent submitters; a sharded plan;
  values given as tensors (float32 and bfloat16 plans); the metrics reach
  a heartbeat file.
"""
import json
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.spgemm import Outcome as R_Outcome  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import SpGEMMGateway as R_SpGEMMGateway  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.data.pipeline import SpGEMMValueStream  # noqa: E402
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.runtime.heartbeat import Heartbeat, MetricsRegistry  # noqa: E402
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.random import random_block_sparse, random_coo  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    GatewayShed,
    Outcome,
    PlanCache,
    SpGEMMGateway,
    SpGEMMPipeline,
    spgemm_plan,
)

WAIT = 60  # per-ticket bound: a hang fails the test instead of the run


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patterns(seed=0, m=96, k=72, n=80, density=0.06):
    a = random_coo(m, k, density, "uniform", seed=seed).sum_duplicates()
    b = random_coo(k, n, density, "uniform", seed=seed + 1).sum_duplicates()
    return a, b


def _ref(coo) -> R_COO:
    return R_COO(np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.val), coo.shape)


def _gateway(**kw):
    kw.setdefault("cache", PlanCache())
    return SpGEMMGateway(**kw)


def _register(gw, token, a, b, **kw):
    return gw.register(token, a, b, tile=8, group=2, device="cpu", **kw)


def _same_csr(x, y):
    assert np.array_equal(x.indptr, y.indptr)
    assert np.array_equal(x.indices, y.indices)
    assert np.array_equal(x.data, y.data)


# -- against the reference -------------------------------------------------------------

def _outcome_scenario(gw_cls, cache_cls, register, outcome_of):
    """Queue bound 3 and a byte budget of five requests, nothing
    dispatching: admissions, typed sheds, then a cache over its byte
    budget, a close without drain and a submit after close. Returns the
    outcome names in ticket order and the per-pattern shed counts."""
    a, b = _patterns(0)
    vals = SpGEMMValueStream(a, b, seed=7)
    cache = cache_cls()
    gw = gw_cls(cache=cache, max_queue=3, start=False)
    plan = register(gw, "p", a, b)
    q_plan = register(gw, "q", *_patterns(4))
    gw.max_inflight_bytes = 3 * plan.value_nbytes() + 2 * q_plan.value_nbytes() + 16
    qv = SpGEMMValueStream(*_patterns(4), seed=8)
    tickets = [gw.submit("p", *vals.values_at(s)) for s in range(5)]
    tickets += [gw.submit("q", *qv.values_at(s)) for s in range(3)]
    done_early = [outcome_of(t.wait(0)) if t.done() else "pending" for t in tickets]
    gw.max_inflight_bytes = None
    cache.max_bytes = 1  # any resident plan now overflows the budget
    tickets.append(gw.submit("q", *qv.values_at(9)))
    cache.max_bytes = None
    gw.close(drain=False)
    tickets.append(gw.submit("p", *vals.values_at(9)))
    stats = gw.stats()["patterns"]
    return (done_early, [outcome_of(t.wait(0)) for t in tickets],
            {k: v["shed"] for k, v in stats.items()})


def test_unstarted_outcome_sequence_equals_the_reference():
    got = _outcome_scenario(
        SpGEMMGateway, PlanCache,
        lambda gw, t, a, b: gw.register(t, a, b, tile=8, group=2, device="cpu"),
        lambda r: r.outcome.value)
    want = _outcome_scenario(
        R_SpGEMMGateway, R_PlanCache,
        lambda gw, t, a, b: gw.register(t, _ref(a), _ref(b), tile=8, group=2, backend="jnp"),
        lambda r: r.outcome.value)
    assert got == want
    early, final, shed = got
    assert early == ["pending"] * 3 + ["shed_queue_full"] * 2 + ["pending"] * 2 + ["shed_bytes"]
    assert final == ["shed_closed"] * 3 + ["shed_queue_full"] * 2 + ["shed_closed"] * 2 + [
        "shed_bytes", "shed_cache_pressure", "shed_closed"]
    assert shed == {"p": {"shed_queue_full": 2, "shed_closed": 4},
                    "q": {"shed_closed": 2, "shed_bytes": 1, "shed_cache_pressure": 1}}


def test_small_integer_results_equal_the_reference_execute():
    a, b = _patterns(2)
    rng = np.random.default_rng(5)
    sets = [(rng.integers(-3, 4, a.nnz).astype(np.float32),
             rng.integers(-3, 4, b.nnz).astype(np.float32)) for _ in range(6)]
    with _gateway(max_batch=4) as gw:
        _register(gw, "p", a, b)
        results = [t.wait(WAIT) for t in [gw.submit("p", av, bv) for av, bv in sets]]
    ref = r_spgemm_plan(_ref(a), _ref(b), tile=8, group=2, backend="jnp", cache=R_PlanCache())
    for (av, bv), r in zip(sets, results):
        assert r.outcome is Outcome.OK
        _same_csr(r.value, ref.execute(av, bv))
    assert [o.value for o in Outcome] == [o.value for o in R_Outcome]


# -- results ---------------------------------------------------------------------------------

def test_bitwise_equal_direct_execute_two_patterns():
    gw = _gateway(max_pipelines=2, depth=2, max_batch=4, batch_window=0.002)
    p0 = _register(gw, "p0", *_patterns(0))
    p1 = _register(gw, "p1", *_patterns(4, m=64, k=64, n=64, density=0.08))
    s0 = SpGEMMValueStream(p0.a_pattern, p0.b_pattern, seed=7)
    s1 = SpGEMMValueStream(p1.a_pattern, p1.b_pattern, seed=8)
    tickets = []
    for s in range(8):
        tickets.append(("p0", s, gw.submit("p0", *s0.values_at(s))))
        tickets.append(("p1", s, gw.submit("p1", *s1.values_at(s))))
    results = [(tok, s, t.wait(WAIT)) for tok, s, t in tickets]
    gw.close()
    for tok, s, r in results:
        plan, st = (p0, s0) if tok == "p0" else (p1, s1)
        assert r.outcome is Outcome.OK
        _same_csr(plan.execute(*st.values_at(s)), r.value)


def test_micro_batching_fills_batches():
    gw = _gateway(max_batch=4, start=False)
    plan = _register(gw, "p", *_patterns(0))
    st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    tickets = [gw.submit("p", *st.values_at(s)) for s in range(8)]
    gw.start()
    assert all(t.wait(WAIT).outcome is Outcome.OK for t in tickets)
    stats = gw.stats()["patterns"]["p"]
    gw.close()
    assert (stats["dispatches"], stats["batched_requests"], stats["batch_fill"]) == (2, 8, 4.0)
    assert stats["latency_s"]["count"] == 8 and stats["throughput_rps"] > 0


def test_block_plan_requests():
    ad = random_block_sparse(128, 128, (32, 32), 0.3, seed=3)
    bd = random_block_sparse(128, 128, (32, 32), 0.3, seed=4)
    cache = PlanCache()
    plan = spgemm_plan(to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32)), device="cpu",
                       cache=cache)
    gw = _gateway(cache=cache, max_batch=2)
    gw.register_plan("blk", plan)
    rng = np.random.default_rng(0)
    wa, wb = plan.value_shapes()
    sets = [(rng.standard_normal(wa).astype(np.float32),
             rng.standard_normal(wb).astype(np.float32)) for _ in range(3)]
    results = [t.wait(WAIT) for t in [gw.submit("blk", a, b) for a, b in sets]]
    gw.close()
    for (a, b), r in zip(sets, results):
        assert r.outcome is Outcome.OK
        _same_csr(plan.execute(a, b), r.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_and_mixed_requests(dtype):
    """Values given as tensors, numpy arrays of another float type, or a mix
    in one micro-batch: rounded to the plan's dtype exactly as ``execute``
    rounds them."""
    a, b = _patterns(6)
    ta = torch.sparse_coo_tensor(np.stack([a.row, a.col]), torch.tensor(a.val).to(dtype),
                                 a.shape, check_invariants=True)
    with _gateway(max_batch=4, start=False) as gw:
        plan = gw.register("t", ta, b, tile=8, group=2, device="cpu")
        assert plan.value_dtypes[0] == dtype
        rng = np.random.default_rng(9)
        sets = [(rng.standard_normal(a.nnz), rng.standard_normal(b.nnz)) for _ in range(4)]
        given = [(torch.from_numpy(av).to(dtype), bv.astype(np.float32)) if i % 2
                 else (av, torch.from_numpy(bv)) for i, (av, bv) in enumerate(sets)]
        tickets = [gw.submit("t", av, bv) for av, bv in given]
        gw.start()
        results = [t.wait(WAIT) for t in tickets]
    for (av, bv), r in zip(given, results):
        assert r.outcome is Outcome.OK
        _same_csr(plan.execute(av, bv), r.value)
    assert results[0].value.data is not results[1].value.data


def test_ticket_api_and_validation():
    gw = _gateway(start=False)
    plan = _register(gw, "p", *_patterns(0))
    st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    with pytest.raises(KeyError):
        gw.submit("nope", *st.values_at(0))
    with pytest.raises(ValueError):
        gw.submit("p", np.zeros(3, np.float32), np.zeros(3, np.float32))
    t = gw.submit("p", *st.values_at(0))
    assert not t.done()
    with pytest.raises(TimeoutError):
        t.wait(timeout=0.01)
    with pytest.raises(RuntimeError, match="not running"):
        gw.drain(timeout=0.1)
    gw.start()
    res = t.wait(WAIT)
    assert res.outcome is Outcome.OK and res.latency_s > 0 and res.seq == 1
    assert t.result() is res.value
    gw.close()
    with pytest.raises(RuntimeError, match="closed"):
        gw.start()


def test_duplicate_registration():
    gw = _gateway(start=False)
    a, b = _patterns(0)
    plan = _register(gw, "p", a, b)
    assert _register(gw, "p", a, b) is plan
    other = _register(gw, "q", *_patterns(4))
    with pytest.raises(ValueError):
        gw.register_plan("p", other)
    assert gw.patterns() == ("p", "q")
    gw.close()
    with pytest.raises(RuntimeError):
        gw.register_plan("r", other)


@pytest.mark.parametrize("kw", [dict(max_pipelines=0), dict(depth=0), dict(max_batch=0),
                                dict(max_queue=0), dict(batch_window=-1.0)])
def test_constructor_rejects_bad_bounds(kw):
    with pytest.raises(ValueError):
        SpGEMMGateway(cache=PlanCache(), start=False, **kw)


def test_failed_dispatch_resolves_failed_with_the_error(monkeypatch):
    gw = _gateway(start=False)
    plan = _register(gw, "p", *_patterns(0))
    st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    boom = RuntimeError("device fault")

    def fail(*_a, **_k):
        raise boom

    monkeypatch.setattr(plan, "_pipe_dispatch", fail)
    t = gw.submit("p", *st.values_at(0))
    gw.start()
    res = t.wait(WAIT)
    gw.close()
    assert res.outcome is Outcome.FAILED and res.error is boom
    with pytest.raises(RuntimeError, match="device fault"):
        t.result()
    assert gw.stats()["patterns"]["p"]["failed"] == 1


# -- backpressure -------------------------------------------------------------------------------

def test_queue_full_sheds_typed():
    gw = _gateway(max_queue=2, start=False)
    plan = _register(gw, "p", *_patterns(0))
    st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    tickets = [gw.submit("p", *st.values_at(s)) for s in range(5)]
    shed = [t for t in tickets if t.done()]
    assert len(shed) == 3 and all(t.wait(0).outcome is Outcome.SHED_QUEUE_FULL for t in shed)
    with pytest.raises(GatewayShed) as ei:
        shed[0].result()
    assert ei.value.outcome is Outcome.SHED_QUEUE_FULL and ei.value.outcome.shed
    gw.start()
    for s, t in enumerate(tickets[:2]):
        res = t.wait(WAIT)
        assert res.outcome is Outcome.OK
        _same_csr(plan.execute(*st.values_at(s)), res.value)
    stats = gw.stats()["patterns"]["p"]
    gw.close()
    assert stats["shed"]["shed_queue_full"] == stats["shed_total"] == 3


def test_byte_budget_sheds_not_hangs():
    a, b = _patterns(0)
    cache = PlanCache()
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache)
    nb = plan.value_nbytes()
    gw = _gateway(cache=cache, max_inflight_bytes=3 * nb + 16, start=False)
    gw.register_plan("p", plan)
    st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    tickets = [gw.submit("p", *st.values_at(s)) for s in range(6)]
    assert [t.wait(0).outcome if t.done() else None for t in tickets].count(
        Outcome.SHED_BYTES) == 3
    gw.start()
    done = [t.wait(WAIT) for t in tickets]
    gw.close()
    assert [r.outcome for r in done].count(Outcome.OK) == 3
    for s, r in enumerate(done[:3]):
        _same_csr(plan.execute(*st.values_at(s)), r.value)
    assert gw.stats()["inflight_bytes"] == 0


def test_budget_below_one_request_sheds_everything():
    a, b = _patterns(0)
    with _gateway(max_inflight_bytes=8) as gw:
        plan = _register(gw, "p", a, b)
        st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
        results = [gw.submit("p", *st.values_at(s)).wait(1.0) for s in range(4)]
    assert all(r.outcome is Outcome.SHED_BYTES for r in results)


def test_close_without_drain_sheds_queued():
    gw = _gateway(start=False)
    plan = _register(gw, "p", *_patterns(0))
    st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    tickets = [gw.submit("p", *st.values_at(s)) for s in range(3)]
    gw.close(drain=False)
    assert all(t.wait(0).outcome is Outcome.SHED_CLOSED for t in tickets)
    assert gw.submit("p", *st.values_at(9)).wait(0).outcome is Outcome.SHED_CLOSED
    gw.close()  # idempotent


def test_context_manager_drains():
    with _gateway(max_batch=4) as gw:
        plan = _register(gw, "p", *_patterns(0))
        st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
        tickets = [gw.submit("p", *st.values_at(s)) for s in range(4)]
    assert all(t.wait(0).outcome is Outcome.OK for t in tickets)
    assert gw.stats()["pipelines_live"] == 0 and plan.in_flight == 0


# -- fairness and the pipeline pool ---------------------------------------------------------------

def test_hot_tenant_cannot_starve_cold():
    gw = _gateway(max_pipelines=2, max_batch=4, batch_window=0.0, start=False)
    hot = _register(gw, "hot", *_patterns(0))
    cold = _register(gw, "cold", *_patterns(4))
    sh = SpGEMMValueStream(hot.a_pattern, hot.b_pattern, seed=7)
    sc = SpGEMMValueStream(cold.a_pattern, cold.b_pattern, seed=8)
    hot_t = [gw.submit("hot", *sh.values_at(s)) for s in range(32)]
    cold_t = [gw.submit("cold", *sc.values_at(s)) for s in range(2)]
    gw.start()
    hot_seq = [t.wait(WAIT).seq for t in hot_t]
    cold_seq = [t.wait(WAIT).seq for t in cold_t]
    stats = gw.stats()
    gw.close()
    assert max(cold_seq) < 0.5 * max(hot_seq), (cold_seq, max(hot_seq))
    assert stats["patterns"]["hot"]["completed"] == 32
    assert stats["patterns"]["cold"]["completed"] == 2
    assert stats["patterns"]["cold"]["latency_s"]["p99"] > 0


def test_pool_eviction_bounded_and_counted():
    gw = _gateway(max_pipelines=1, max_batch=2, batch_window=0.0)
    pA = _register(gw, "A", *_patterns(0))
    pB = _register(gw, "B", *_patterns(4))
    sA = SpGEMMValueStream(pA.a_pattern, pA.b_pattern, seed=7)
    sB = SpGEMMValueStream(pB.a_pattern, pB.b_pattern, seed=8)
    tickets = []
    for s in range(6):
        tickets.append(gw.submit("A", *sA.values_at(s)))
        tickets.append(gw.submit("B", *sB.values_at(s)))
    assert all(t.wait(WAIT).outcome is Outcome.OK for t in tickets)
    stats = gw.stats()
    gw.close()
    assert stats["pipelines_live"] <= 1 and stats["pipeline_evictions"] >= 1


def test_eviction_never_tears_down_inflight_pipeline():
    """The pin guard at gateway level: with the pool held by a pipeline
    with a ticket in flight, another pattern's work waits; the busy
    pipeline's ticket stays collectable."""
    gw = _gateway(max_pipelines=1, batch_window=0.0, start=False)
    pA = _register(gw, "A", *_patterns(0))
    pB = _register(gw, "B", *_patterns(4))
    sA = SpGEMMValueStream(pA.a_pattern, pA.b_pattern, seed=7)
    sB = SpGEMMValueStream(pB.a_pattern, pB.b_pattern, seed=8)
    stA = gw._states["A"]
    stA.pipeline = SpGEMMPipeline(pA, depth=2)
    gw._pipelines_live = 1
    ta = stA.pipeline.submit(*sA.values_at(0))
    tb = gw.submit("B", *sB.values_at(0))
    gw.start()
    time.sleep(0.25)  # many dispatch rounds: B must still be waiting
    assert not tb.done()
    assert stA.pipeline is gw._states["A"].pipeline and stA.pipeline.in_flight == 1
    _same_csr(pA.execute(*sA.values_at(0)), stA.pipeline.collect(ta))
    res = tb.wait(WAIT)
    gw.close()
    assert res.outcome is Outcome.OK
    _same_csr(pB.execute(*sB.values_at(0)), res.value)


def test_threads_submit_concurrently():
    gw = _gateway(max_pipelines=2, max_batch=4, batch_window=0.002)
    p0 = _register(gw, "p0", *_patterns(0))
    p1 = _register(gw, "p1", *_patterns(4))
    streams = {"p0": SpGEMMValueStream(p0.a_pattern, p0.b_pattern, seed=7),
               "p1": SpGEMMValueStream(p1.a_pattern, p1.b_pattern, seed=8)}
    results, lock = {}, threading.Lock()

    def tenant(tid, token):
        tickets = [(tid * 100 + s, gw.submit(token, *streams[token].values_at(tid * 100 + s)))
                   for s in range(6)]
        for step, t in tickets:
            r = t.wait(WAIT)
            with lock:
                results[(token, step)] = r

    threads = [threading.Thread(target=tenant, args=(i, tok))
               for i, tok in enumerate(["p0", "p1", "p0", "p1"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stats = gw.stats()["patterns"]
    gw.close()
    assert len(results) == 24 and all(r.outcome is Outcome.OK for r in results.values())
    for (token, step), r in results.items():
        plan = p0 if token == "p0" else p1
        _same_csr(plan.execute(*streams[token].values_at(step)), r.value)
    assert sum(s["dispatches"] for s in stats.values()) <= 24


def test_gateway_over_sharded_plan():
    a, b = _patterns(0)
    cache = PlanCache()
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache,
                       mesh=make_shard_mesh(4, devices=["cpu"] * 4))
    with SpGEMMGateway(cache=cache, max_batch=2, batch_window=0.0) as gw:
        gw.register_plan("sharded", plan)
        st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
        results = [t.wait(WAIT) for t in [gw.submit("sharded", *st.values_at(s))
                                          for s in range(4)]]
    single = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache())
    for s, r in enumerate(results):
        assert r.outcome is Outcome.OK
        _same_csr(plan.execute(*st.values_at(s)), r.value)
        _same_csr(single.execute(*st.values_at(s)), r.value)


def test_metrics_reach_a_heartbeat_export(tmp_path):
    reg = MetricsRegistry()
    with _gateway(metrics=reg, max_batch=2) as gw:
        plan = _register(gw, "p", *_patterns(0))
        st = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
        for t in [gw.submit("p", *st.values_at(s)) for s in range(4)]:
            t.wait(WAIT)
        beat = Heartbeat(str(tmp_path), host="gw", metrics=reg)
        beat.beat()
    rec = json.loads((tmp_path / "heartbeat_gw.json").read_text())
    m = rec["metrics"]
    assert m["gateway.p.submitted"] == m["gateway.p.completed"] == 4
    assert m["gateway.p.latency_s"]["count"] == 4 and "gateway.inflight_bytes" in m
    assert m["gateway.p.batched_requests"] == 4
