"""Port parity: the asynchronous submit/collect pipeline and the SpGEMM
value stream of ``repro_torch`` (on the CPU, where the pipeline runs its
protocol synchronously) against the JAX package with ``backend="jnp"``.

The load-bearing invariant is *bitwise equality*: a pipelined stream of N
steps reproduces N sequential ``execute`` calls exactly, on element,
block and batched plans at every depth; on small-integer values it also
equals the reference's pipelined results bitwise, and within 1e-5 on
random float32. The semantics follow ``tests/test_pipeline.py``:
out-of-order and oldest-first collect, depth exhaustion, double and
foreign collects, invalid submits, poisoned steps, close, release guards
and abandoned tickets. The plan cache's eviction guards are in
``tests/test_torch_cache.py``, the sharded pipeline in
``tests/test_torch_sharded.py``.
"""
import gc

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.data.pipeline import SpGEMMValueStream as R_SpGEMMValueStream  # noqa: E402
from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.data.pipeline import SpGEMMValueStream  # noqa: E402
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.sparse.random import random_block_sparse  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    PipelineFullError,
    SpGEMMPipeline,
    SpGEMMTicket,
    spgemm_plan,
)


def _coos(seed, m=96, n=80, k=72, density=0.06):
    a = r_random_coo(m, k, density, "uniform", seed=seed).sum_duplicates()
    b = r_random_coo(k, n, density, "uniform", seed=seed + 1).sum_duplicates()
    return ((COO(a.row, a.col, a.val, a.shape), a), (COO(b.row, b.col, b.val, b.shape), b))


def _element_plan(seed=0):
    (ta, _), (tb, _) = _coos(seed)
    return spgemm_plan(ta, tb, tile=8, group=2, device="cpu")


def _element_plans(seed):
    """The same element plan in both packages."""
    (ta, ra), (tb, rb) = _coos(seed)
    return (spgemm_plan(ta, tb, tile=8, group=2, device="cpu"),
            r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=PlanCache()))


def _block_plan():
    ad = random_block_sparse(128, 128, (32, 32), 0.3, seed=3)
    bd = random_block_sparse(128, 128, (32, 32), 0.3, seed=4)
    return spgemm_plan(to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32)), device="cpu")


def _stream(plan, seed=2, **kw):
    return SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=seed, **kw)


def _assert_same_csr(x, y):
    assert np.array_equal(x.indptr, np.asarray(y.indptr))
    assert np.array_equal(x.indices, np.asarray(y.indices))
    assert np.array_equal(x.data, np.asarray(y.data))


# -- the value stream ---------------------------------------------------------

@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("batch", [None, 3])
def test_value_stream_matches_reference(integer, batch):
    """Drawn from the seed with numpy exactly as the reference draws: equal
    arrays step by step, batched and through the prefetching iterator."""
    (ta, ra), (tb, rb) = _coos(5)
    got = SpGEMMValueStream(ta, tb, seed=7, integer_values=integer, batch=batch)
    want = R_SpGEMMValueStream(ra, rb, seed=7, integer_values=integer, batch=batch)
    for step in (0, 3):
        for g, w in zip(got.values_at(step), want.values_at(step)):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
        for key, g in got.batch_at(step).items():
            assert np.array_equal(g, want.batch_at(step)[key])
    for (ga, gb), (wa, wb) in zip(got.value_iter(start_step=2, steps=3),
                                  want.value_iter(start_step=2, steps=3)):
        assert np.array_equal(ga, wa) and np.array_equal(gb, wb)
    if integer:
        assert np.all(np.abs(got.values_at(0)[0]) <= 4) and np.all(got.values_at(0)[0] != 0)


def test_value_stream_checks_and_forwards_errors():
    (ta, _), (tb, _) = _coos(6)
    with pytest.raises(ValueError, match="inner dims"):
        SpGEMMValueStream(ta, ta, seed=0)
    with pytest.raises(ValueError, match="batch must be"):
        SpGEMMValueStream(ta, tb, batch=0)
    with pytest.raises(ValueError, match="no batch size"):
        SpGEMMValueStream(ta, tb).values_batch_at(0)
    stream = SpGEMMValueStream(ta, tb)
    stream.values_at = lambda step: (_ for _ in ()).throw(RuntimeError(f"boom {step}"))
    with pytest.raises(RuntimeError, match="boom 0"):
        next(stream.value_iter())


# -- bitwise equality ---------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("kind", ["element", "block", "batched"])
def test_pipelined_matches_sequential(depth, kind):
    """Pipelined == sequential ``execute`` (``execute_batch`` for batched
    submits), bitwise, at depths 1, 2 and 4."""
    rng = np.random.default_rng(depth)
    if kind == "block":
        plan = _block_plan()
        sets = [(rng.standard_normal(plan._a_shape).astype(np.float32),
                 rng.standard_normal(plan._b_shape).astype(np.float32)) for _ in range(5)]
        seq = [plan.execute(a, b) for a, b in sets]
    elif kind == "element":
        plan = _element_plan()
        stream = _stream(plan, seed=7)
        sets = [stream.values_at(s) for s in range(6)]
        seq = [plan.execute(*v) for v in sets]
    else:
        plan = _element_plan(11)
        stream = _stream(plan, seed=5)
        sets = [stream.values_batch_at(s, batch=3) for s in range(4)]
        seq = [plan.execute_batch(*v) for v in sets]
    with plan.pipeline(depth=depth) as pipe:
        out = list(pipe.stream(iter(sets)))
    assert len(out) == len(seq)
    for want, got in zip(seq, out):
        if kind == "batched":
            assert len(got) == len(want) == 3
            for w, g in zip(want, got):
                _assert_same_csr(g, w)
        else:
            _assert_same_csr(got, want)
    assert plan.in_flight == 0


@pytest.mark.parametrize("integer", [False, True])
def test_execute_stream_matches_reference(integer):
    """``execute_stream`` fed by ``SpGEMMValueStream.value_iter`` equals the
    reference's ``execute_stream`` on the same stream: bitwise on small
    integers, 1e-5 on random float32."""
    plan, want = _element_plans(31)
    got = list(plan.execute_stream(
        _stream(plan, seed=9, integer_values=integer).value_iter(steps=4), depth=2))
    ref = list(want.execute_stream(R_SpGEMMValueStream(
        want.a_pattern, want.b_pattern, seed=9, integer_values=integer).value_iter(steps=4),
        depth=2))
    assert len(got) == len(ref) == 4
    for g, w in zip(got, ref):
        assert np.array_equal(g.indptr, np.asarray(w.indptr))
        assert np.array_equal(g.indices, np.asarray(w.indices))
        if integer:
            assert np.array_equal(g.data, np.asarray(w.data))
        else:
            np.testing.assert_allclose(g.data, np.asarray(w.data), rtol=1e-5, atol=1e-5)


def test_batched_submit_and_execute_async_match_reference():
    """A submit with a leading batch axis == ``execute_batch``, and the
    reference's ``execute_async``, on small integers."""
    plan, want = _element_plans(13)
    av, bv = _stream(plan, seed=5, integer_values=True).values_batch_at(0, batch=4)
    got = plan.execute_async(av, bv)
    assert isinstance(got, SpGEMMTicket) and got.batch == 4
    got = got.result()
    for g, e, w in zip(got, plan.execute_batch(av, bv), want.execute_async(av, bv).result()):
        _assert_same_csr(g, e)
        _assert_same_csr(g, w)


def test_noarg_submit_uses_staged_values():
    plan = _element_plan(21)
    _assert_same_csr(plan.execute_async().result(), plan.execute())
    bp = _block_plan()
    _assert_same_csr(bp.execute_async().result(), bp.execute())


def test_tensor_operands_match_numpy_operands():
    plan = _element_plan(23)
    av, bv = _stream(plan).values_at(0)
    got = plan.execute_async(torch.from_numpy(av), torch.from_numpy(bv)).result()
    _assert_same_csr(got, plan.execute(av, bv))


def test_empty_plan_pipeline():
    """Disjoint patterns: pipelined results are the empty CSR the
    synchronous path returns."""
    a = COO(np.array([0]), np.array([0]), np.ones(1, np.float32), (16, 16))
    b = COO(np.array([8]), np.array([0]), np.ones(1, np.float32), (16, 16))
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu")
    one = np.ones(1, np.float32)
    want = plan.execute(one, one)
    _assert_same_csr(plan.execute_async(one, one).result(), want)
    got_b = plan.execute_async(np.ones((2, 1), np.float32), np.ones((2, 1), np.float32)).result()
    assert len(got_b) == 2
    for g in got_b:
        _assert_same_csr(g, want)


def test_results_own_their_values():
    """A collected result is not written by later steps: step s's CSR is
    unchanged after steps s + 1 .. s + depth ran."""
    plan = _element_plan(25)
    stream = _stream(plan)
    with plan.pipeline(depth=2) as pipe:
        first = pipe.submit(*stream.values_at(0)).result()
        kept = first.data.copy()
        for s in range(1, 4):
            pipe.submit(*stream.values_at(s))
            pipe.collect()
    assert np.array_equal(first.data, kept)
    _assert_same_csr(first, plan.execute(*stream.values_at(0)))


# -- pipeline semantics -----------------------------------------------------------

def test_out_of_order_and_oldest_first_collect():
    plan = _element_plan(41)
    stream = _stream(plan)
    seq = [plan.execute(*stream.values_at(s)) for s in range(3)]
    with plan.pipeline(depth=3) as pipe:
        tickets = [pipe.submit(*stream.values_at(s)) for s in range(3)]
        c2 = pipe.collect(tickets[2])
        c0 = pipe.collect()  # the oldest outstanding
        c1 = tickets[1].result()
        with pytest.raises(ValueError, match="nothing in flight"):
            pipe.collect()
    for want, got in zip(seq, (c0, c1, c2)):
        _assert_same_csr(got, want)


def test_depth_exhaustion_and_refill():
    plan = _element_plan(51)
    stream = _stream(plan)
    pipe = plan.pipeline(depth=2)
    assert pipe.depth == 2 and pipe.free_slots == 2
    t0 = pipe.submit(*stream.values_at(0))
    pipe.submit(*stream.values_at(1))
    assert pipe.in_flight == len(pipe) == 2 and pipe.free_slots == 0
    with pytest.raises(PipelineFullError, match="depth 2 exhausted"):
        pipe.submit(*stream.values_at(2))
    pipe.collect(t0)  # frees a slot
    pipe.submit(*stream.values_at(2))
    assert pipe.in_flight == 2
    list(pipe)  # drain
    assert pipe.in_flight == 0 and plan.in_flight == 0
    assert plan.pipeline().depth == 2  # the paper's double buffer by default
    with pytest.raises(ValueError, match="depth must be"):
        SpGEMMPipeline(plan, depth=0)


@pytest.mark.parametrize("misuse", ["double", "foreign"])
def test_bad_collects_raise(misuse):
    plan = _element_plan(71)
    stream = _stream(plan)
    p1, p2 = plan.pipeline(depth=1), plan.pipeline(depth=1)
    t = p1.submit(*stream.values_at(0))
    if misuse == "double":
        t.result()
        with pytest.raises(ValueError, match="already collected"):
            t.result()
    else:
        with pytest.raises(ValueError, match="different pipeline"):
            p2.collect(t)
        t.result()
    assert plan.in_flight == 0


def test_invalid_submit_holds_no_slot():
    plan = _element_plan(91)
    pipe = plan.pipeline(depth=1)
    with pytest.raises(ValueError, match="expected a_vals"):
        pipe.submit(np.ones(3, np.float32), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="both a_vals and b_vals"):
        pipe.submit(np.ones(3, np.float32), None)
    assert pipe.in_flight == 0 and plan.in_flight == 0 and pipe.free_slots == 1


def test_poisoned_step_propagates_at_collect(monkeypatch):
    """A step whose dispatch fails re-raises at *its* collect; neighbours
    stay collectable and the pipeline stays usable."""
    plan = _element_plan(101)
    stream = _stream(plan)
    seq = [plan.execute(*stream.values_at(s)) for s in range(3)]
    ex = plan._executor
    real = ex.pipe_kernel
    calls = {"n": 0}

    def flaky(staged, *, mode):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom at step 1")
        return real(staged, mode=mode)

    monkeypatch.setattr(ex, "pipe_kernel", flaky)
    pipe = plan.pipeline(depth=3)
    tickets = [pipe.submit(*stream.values_at(s)) for s in range(3)]
    _assert_same_csr(tickets[0].result(), seq[0])
    with pytest.raises(RuntimeError, match="boom at step 1"):
        tickets[1].result()
    _assert_same_csr(tickets[2].result(), seq[2])
    assert plan.in_flight == 0  # the poisoned slot was freed too
    monkeypatch.setattr(ex, "pipe_kernel", real)
    _assert_same_csr(pipe.submit(*stream.values_at(0)).result(), seq[0])


def test_closed_pipeline_rejects_submit_and_unpins_the_plan():
    plan = _element_plan(111)
    stream = _stream(plan)
    pipe = plan.pipeline(depth=2)
    pipe.submit(*stream.values_at(0))
    pipe.submit(*stream.values_at(1))
    with pytest.raises(RuntimeError, match="in-flight pipeline"):
        plan.release_values()
    pipe.close()
    assert plan.in_flight == 0 and pipe.free_slots == 0
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit()
    plan.release_values()


def test_abandoned_stream_and_ticket_do_not_pin_the_plan():
    """Dropping an uncollected ``execute_async`` ticket (and its hidden
    pipeline), or a half-consumed stream, releases the plan's in-flight
    count."""
    plan = _element_plan(171)
    stream = _stream(plan)
    t = plan.execute_async(*stream.values_at(0))
    assert plan.in_flight == 1
    del t
    gc.collect()
    assert plan.in_flight == 0
    it = plan.execute_stream((stream.values_at(s) for s in range(5)), depth=2)
    next(it)
    it.close()
    assert plan.in_flight == 0
    plan.release_values()  # legal: nothing pins the plan


# -- teardown -----------------------------------------------------------------

def test_release_guards_while_in_flight():
    plan = _element_plan(121)
    stream = _stream(plan)
    t = plan.pipeline(depth=2).submit(*stream.values_at(0))
    assert plan.in_flight == 1
    for fn in (plan.release_values, plan.release_device_values, plan.release):
        with pytest.raises(RuntimeError, match="in-flight pipeline"):
            fn()
    t.result()
    assert plan.in_flight == 0
    plan.release_values()  # legal again once drained


def test_release_values_then_explicit_values():
    """After ``release_values`` the plan needs explicit values; they give
    the same result as before, and ``execute_batch`` is unaffected."""
    plan = _element_plan(131)
    av, bv = _stream(plan).values_at(0)
    want = plan.execute(av, bv)
    nbytes = plan.host_nbytes()
    plan.release_values()
    assert plan.host_nbytes() < nbytes
    with pytest.raises(ValueError, match="released"):
        plan.execute()
    with pytest.raises(ValueError, match="released"):
        plan.execute_async()
    _assert_same_csr(plan.execute_batch(av[None], bv[None])[0], want)
    _assert_same_csr(plan.execute(av, bv), want)
    plan.release_device_values()
    _assert_same_csr(plan.execute(), want)  # the rebind restaged the host blocks


def test_released_plan_refuses_work():
    plan = _element_plan(141)
    stream = _stream(plan)
    plan.release()
    for call in (lambda: plan.execute(*stream.values_at(0)),
                 lambda: plan.execute_batch(*stream.values_batch_at(0, batch=2)),
                 lambda: plan.pipeline().submit(*stream.values_at(0))):
        with pytest.raises(RuntimeError, match="released"):
            call()


def test_submit_while_a_collect_waits(monkeypatch):
    """A slot is held until its collect has waited: a submit from another
    thread while a collect is waiting sees a full pipeline (typed), never
    an empty slot list, and gets the slot once the collect returns."""
    import threading

    plan = _element_plan(8)
    stream = _stream(plan)
    pipe = SpGEMMPipeline(plan, depth=1)
    ticket = pipe.submit(*stream.values_at(0))
    waiting, release = threading.Event(), threading.Event()
    real = plan._pipe_collect

    def slow_collect(prep, packed):
        waiting.set()
        release.wait(10)
        return real(prep, packed)

    monkeypatch.setattr(plan, "_pipe_collect", slow_collect)
    got = []
    collector = threading.Thread(target=lambda: got.append(pipe.collect(ticket)))
    collector.start()
    assert waiting.wait(10)
    assert pipe.in_flight == 0 and pipe.free_slots == 0
    with pytest.raises(PipelineFullError, match="1 step"):
        pipe.submit(*stream.values_at(1))
    release.set()
    collector.join(10)
    assert pipe.free_slots == 1
    _assert_same_csr(got[0], plan.execute(*stream.values_at(0)))
    _assert_same_csr(pipe.submit(*stream.values_at(1)).result(),
                     plan.execute(*stream.values_at(1)))
    pipe.close()


def test_concurrent_submit_and_collect_stress():
    """More threads than cores share one depth-2 pipeline, each submitting
    and then collecting its own steps, with a short switch interval: every
    submit either takes a slot or raises ``PipelineFullError`` (never an
    error from an empty slot list), every result equals ``execute``, and
    all slots come back."""
    import os
    import sys
    import threading

    plan = _element_plan(9)
    stream = _stream(plan)
    want = [plan.execute(*stream.values_at(s)).data for s in range(4)]
    pipe = SpGEMMPipeline(plan, depth=2)
    n_threads = (os.cpu_count() or 4) + 2
    errors, done = [], []

    def worker(tid):
        try:
            for i in range(6):
                s = (tid + i) % 4
                while True:
                    try:
                        ticket = pipe.submit(*stream.values_at(s))
                        break
                    except PipelineFullError:
                        pass
                assert np.array_equal(pipe.collect(ticket).data, want[s])
            done.append(tid)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:1]
    assert sorted(done) == list(range(n_threads))
    assert pipe.in_flight == 0 and pipe.free_slots == 2 and plan.in_flight == 0
    pipe.close()
