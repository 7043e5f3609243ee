"""The port's spans (``repro_torch.runtime.heartbeat``): off unless a torch
profiler records or ``set_tracing(True)``; nested by parent and root ids,
per thread; a bounded buffer that counts what it drops; a clock anchor that
puts the spans on the profiler's clock; the spans of ``execute`` and
``spgemm_plan`` on the CPU, and the bytes they count."""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.runtime import heartbeat as hb
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo
from repro_torch.sparse.random import random_coo
from repro_torch.spgemm import PlanCache, execute_chain, spgemm_plan

ROOT = Path(__file__).resolve().parents[1]

EXECUTE = ["spgemm.execute", "spgemm.execute.rebind", "spgemm.execute.upload",
           "spgemm.execute.launch", "spgemm.execute.download", "spgemm.execute.wrap"]
PLAN = ["spgemm.plan", "spgemm.plan.inputs", "spgemm.plan.convert", "spgemm.plan.schedule",
        "spgemm.plan.assembly", "spgemm.plan.stage"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    hb.set_tracing(False)
    hb.default_recorder().clear()
    yield
    hb.set_tracing(False)
    hb.default_recorder().clear()


def _operands():
    return random_coo(96, 80, 0.06, seed=3), random_coo(80, 72, 0.06, seed=4)


def _plan():
    a, b = _operands()
    return spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache()), a, b


def _counter(name):
    return hb.default_registry().counter(name).value


def test_off_by_default_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record function {name!r} entered with tracing off")

    monkeypatch.setattr(hb, "_record_function", refuse)
    plan, a, b = _plan()
    plan.execute(a.val, b.val)
    plan.execute()
    plan.execute_batch(np.stack([a.val] * 2), np.stack([b.val] * 2))
    assert hb.spans() == [] and hb.totals() == {"spans": {}, "dropped": 0}
    assert hb.span("x") is hb.span("y")  # the one shared no-op


@pytest.mark.parametrize("how", ["profiler", "set_tracing"])
def test_tracing_is_on_while_asked_and_off_after(how):
    def one():
        with hb.span("t.on"):
            pass

    one()
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            one()
    else:
        hb.set_tracing(True)
        one()
        hb.set_tracing(False)
    one()
    assert [r.name for r in hb.spans()] == ["t.on"]


def test_ids_nest_per_thread():
    """Each thread's spans nest under its own root, also while another
    thread's spans are open and while the starting thread holds a span."""
    hb.set_tracing(True)
    barrier = threading.Barrier(2, timeout=30)

    def worker(tag):
        with hb.span(f"{tag}.root"):
            barrier.wait()
            with hb.span(f"{tag}.child"):
                barrier.wait()
                with hb.span(f"{tag}.leaf"):
                    barrier.wait()

    with hb.span("main.root"):
        threads = [threading.Thread(target=worker, args=(t,)) for t in ("t0", "t1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = {r.name: r for r in hb.spans()}
    assert len(recs) == 7
    roots = set()
    for tag in ("t0", "t1"):
        root, child, leaf = (recs[f"{tag}.{k}"] for k in ("root", "child", "leaf"))
        assert root.parent == 0 and root.root == root.id
        assert child.parent == root.id and leaf.parent == child.id
        assert child.root == leaf.root == root.id
        assert root.start_ns <= child.start_ns <= leaf.start_ns <= leaf.end_ns <= child.end_ns
        roots.add(root.id)
    assert len(roots) == 2 and recs["main.root"].id not in roots


def test_full_buffer_counts_dropped(monkeypatch):
    small = hb.SpanRecorder(capacity=3)
    monkeypatch.setattr(hb, "_RECORDER", small)
    hb.set_tracing(True)
    for i in range(5):
        with hb.span(f"s{i}"):
            pass
    assert [r.name for r in hb.spans()] == ["s0", "s1", "s2"]
    assert small.dropped == 2 and hb.totals()["dropped"] == 2
    small.clear()
    assert hb.spans() == [] and small.dropped == 0 and small.anchor is None


def test_anchor_puts_spans_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with hb.span("anchor.outer"):
                time.sleep(0.002)
                with hb.span("anchor.inner"):
                    time.sleep(0.001)
    rec = hb.default_recorder()
    for name in ("anchor.outer", "anchor.inner"):
        kineto = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                        if e.name() == name and e.device_type() == DeviceType.CPU)
        mine = sorted(rec.profiler_ns(r.start_ns) for r in hb.spans() if r.name == name)
        assert len(kineto) == len(mine) == 3
        assert max(abs(k - m) for k, m in zip(kineto, mine)) < 1_000_000, (kineto, mine)


@pytest.mark.parametrize("call", ["execute_values", "execute_staged", "plan"])
def test_each_call_emits_its_spans_once_inside_its_root(call):
    plan, a, b = _plan()
    hb.set_tracing(True)
    if call == "plan":
        spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    elif call == "execute_values":
        plan.execute(a.val, b.val)
    else:
        plan.execute()
    hb.set_tracing(False)
    names = PLAN if call == "plan" else EXECUTE
    if call == "execute_staged":  # no values given: nothing to rebind
        names = [n for n in names if n != "spgemm.execute.rebind"]
    recs = hb.spans()
    assert sorted(r.name for r in recs) == sorted(names)
    root = next(r for r in recs if r.name == names[0])
    assert root.parent == 0 and root.root == root.id
    children = sorted((r for r in recs if r is not root), key=lambda r: r.start_ns)
    assert [r.name for r in children] == names[1:]
    prev = root.start_ns
    for r in children:
        assert r.parent == root.id and r.root == root.id
        assert prev <= r.start_ns <= r.end_ns <= root.end_ns
        prev = r.end_ns
    t = hb.totals()["spans"]
    covered = sum(t[n]["seconds"] for n in names[1:])
    assert t[names[0]]["self_seconds"] == pytest.approx(t[names[0]]["seconds"] - covered, abs=1e-9)


def _shuffled(coo, seed):
    order = np.random.default_rng(seed).permutation(coo.nnz)
    return type(coo)(coo.row[order], coo.col[order], coo.val[order], coo.shape)


@pytest.mark.parametrize("operands,sorts", [("canonical_a_a", 0), ("shuffled_a_a", 1),
                                            ("one_shuffled", 1), ("two_shuffled", 2)])
def test_the_inputs_span_counts_the_operands_it_sorted(operands, sorts):
    """``sorts`` on ``spgemm.plan.inputs``: the operands that took the
    sort, where one already canonical takes none and A passed as both
    operands is put in order once."""
    a, b = random_coo(80, 80, 0.06, seed=3), random_coo(80, 72, 0.06, seed=4)
    args = {"canonical_a_a": (a, a), "shuffled_a_a": (_shuffled(a, 1),) * 2,
            "one_shuffled": (a, _shuffled(b, 2)),
            "two_shuffled": (_shuffled(a, 1), _shuffled(b, 2))}[operands]
    hb.set_tracing(True)
    spgemm_plan(*args, tile=16, group=2, device="cpu", cache=PlanCache())
    hb.set_tracing(False)
    (rec,) = [r for r in hb.spans() if r.name == "spgemm.plan.inputs"]
    assert rec.counts == {"sorts": sorts}
    assert hb.totals()["spans"]["spgemm.plan.inputs"]["counts"] == {"sorts": sorts}


@pytest.mark.parametrize("output", ["block", "compact", "exact"])
def test_the_assembly_span_counts_a_map_built_on_the_host(output):
    """``on_device`` on ``spgemm.plan.assembly`` is 0 for a CPU plan (only
    a CUDA plan builds its block map on its device)."""
    a, b = _operands()
    hb.set_tracing(True)
    tile, group = (1, 1) if output == "exact" else (16, 2)
    spgemm_plan(a, b, tile=tile, group=group, device="cpu", cache=PlanCache(), output=output)
    hb.set_tracing(False)
    (rec,) = [r for r in hb.spans() if r.name == "spgemm.plan.assembly"]
    assert rec.counts == {"on_device": 0}


def test_counts_set_inside_a_span_join_its_own_and_cost_nothing_off():
    with hb.span("off", bytes=1) as s:
        s.count(sorts=2)
    assert hb.spans() == []
    hb.set_tracing(True)
    with hb.span("on", bytes=1) as s:
        s.count(sorts=2)
    with hb.span("bare") as s:
        s.count(sorts=0)
    hb.set_tracing(False)
    assert {r.name: r.counts for r in hb.spans()} == {"on": {"bytes": 1, "sorts": 2},
                                                    "bare": {"sorts": 0}}


@pytest.mark.parametrize("kind", ["element", "block"])
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("staged", [False, True])
def test_bytes_are_the_bytes_copied(traced, staged, kind):
    """``bytes`` of the upload and the download, and the process-level
    counters (which count traced or not), are the nbytes of the tensors
    that cross: the values in, as the plan holds them (float32 ``[nnz]``
    vectors of an element plan, float32 packed blocks of a block plan),
    whether given to this execute or staged again from the plan's own
    after ``release_device_values``; C's values out."""
    a, b = _operands()
    if kind == "element":
        plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    else:
        plan = spgemm_plan(bcsv_from_coo(a, (16, 16), 2)[0], bcsr_from_coo(b, (16, 16))[0],
                           device="cpu", cache=PlanCache())
    want_a, want_b = plan.value_shapes()
    a_vals = np.random.default_rng(1).standard_normal(want_a)  # float64, copied as float32
    b_vals = np.random.default_rng(2).standard_normal(want_b)
    want_in = 4 * (a_vals.size + b_vals.size)
    if staged:
        plan.execute(a_vals, b_vals)  # the plan now holds these values
        plan.release_device_values()
    h2d, d2h = _counter("spgemm.h2d_bytes"), _counter("spgemm.d2h_bytes")
    hb.set_tracing(traced)
    c = plan.execute() if staged else plan.execute(a_vals, b_vals)
    hb.set_tracing(False)
    assert _counter("spgemm.h2d_bytes") - h2d == want_in
    assert _counter("spgemm.d2h_bytes") - d2h == c.data.nbytes > 0
    counts = {n: s["counts"] for n, s in hb.totals()["spans"].items()}
    if not traced:
        assert counts == {}
        return
    assert counts["spgemm.execute.upload"] == {"bytes": want_in}
    assert counts["spgemm.execute.download"] == {"bytes": c.data.nbytes}


def test_batch_results_are_downloaded_and_wrapped_one_by_one():
    """``execute_batch`` shares the download and the wrap: one of each per
    result, each its own root (no ``execute`` encloses them)."""
    plan, a, b = _plan()
    hb.set_tracing(True)
    out = plan.execute_batch(np.stack([a.val] * 3), np.stack([b.val] * 3))
    hb.set_tracing(False)
    recs = hb.spans()
    assert sorted(r.name for r in recs) == ["spgemm.execute.download"] * 3 + [
        "spgemm.execute.wrap"] * 3
    assert all(r.parent == 0 and r.root == r.id for r in recs)
    got = hb.totals()["spans"]["spgemm.execute.download"]["counts"]["bytes"]
    assert got == sum(c.data.nbytes for c in out)


def _result(surface, plan, vals):
    """One result of ``surface`` on the value pair ``vals``."""
    a_vals, b_vals = vals
    if surface == "execute":
        return plan.execute(a_vals, b_vals)
    if surface == "execute_batch":
        return plan.execute_batch(a_vals[None], b_vals[None])[0]
    chain = plan.then(random_coo(72, 64, 0.06, seed=5), cache=PlanCache())
    return execute_chain(chain, a_vals, b_vals)


@pytest.mark.parametrize("surface", ["execute", "execute_batch", "execute_chain"])
def test_each_result_owns_its_values(surface):
    """A result's values stay as they were after the next request on new
    values, and no two results share memory: no buffer outlives its
    request."""
    plan, a, b = _plan()
    rng = np.random.default_rng(7)
    first_vals, second_vals = [(rng.standard_normal(a.nnz).astype(np.float32),
                                rng.standard_normal(b.nnz).astype(np.float32))
                               for _ in range(2)]
    first = _result(surface, plan, first_vals)
    kept = first.data.copy()
    second = _result(surface, plan, second_vals)
    assert np.array_equal(first.data, kept)
    assert not np.array_equal(second.data, kept)
    assert not np.shares_memory(first.data, second.data)


@pytest.mark.parametrize("output", ["exact", "compact", "block"])
def test_a_chain_records_its_root_and_a_launch_per_later_stage(output):
    """``execute_chain`` runs under ``spgemm.chain`` (its ``stages``,
    ``pairs`` and ``triples``); stage 1 records the execute stages, each
    later stage a ``spgemm.chain.launch`` with its ``pairs``, ``triples``
    and number, and the final copy the download and the wrap. The stages'
    pairs and triples sum to the root's."""
    tile, group = {"exact": (1, 1), "compact": (16, 2), "block": (3, 1)}[output]
    a, b = _operands()
    ops = [random_coo(72, 64, 0.06, seed=5), random_coo(64, 50, 0.06, seed=6)]
    chain = spgemm_plan(a, b, tile=tile, group=group, output=output, device="cpu",
                        cache=PlanCache())
    for c in ops:
        chain = chain.then(c, cache=PlanCache())
    b_vals = np.random.default_rng(8).standard_normal(b.nnz).astype(np.float32)
    hb.set_tracing(True)
    execute_chain(chain, b_vals=b_vals)
    hb.set_tracing(False)
    recs = hb.spans()
    (root,) = [r for r in recs if r.name == "spgemm.chain"]
    assert root.parent == 0 and all(r.root == root.id for r in recs)
    pairs = [q._executor.pairs for q in chain.plans]
    triples = [q.report.num_triples for q in chain.plans]
    assert root.counts == {"stages": 3, "pairs": sum(pairs), "triples": sum(triples)}
    assert min(pairs) > 0 and pairs == [t * (tile ** 3) for t in triples]
    stage_names = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r is not root]
    assert stage_names == EXECUTE[1:4] + ["spgemm.chain.launch"] * 2 + EXECUTE[4:]
    launches = [r for r in recs if r.name.endswith(".launch")]
    assert [r.counts for r in sorted(launches, key=lambda r: r.start_ns)] == [
        {"pairs": pairs[0], "triples": triples[0]},
        {"pairs": pairs[1], "triples": triples[1], "stage": 2},
        {"pairs": pairs[2], "triples": triples[2], "stage": 3}]
    for count in ("pairs", "triples"):
        assert sum(r.counts[count] for r in launches) == root.counts[count]
    if output == "exact":
        assert root.counts["pairs"] == sum(q.report.num_triples for q in chain.plans)


def test_a_small_tile_execute_counts_triples_and_no_launch_on_the_cpu():
    """A tile-3 plan's launch span counts its block triples and its pairs,
    27 a triple; on the CPU the plain version runs, so neither K1's
    launches nor its small-tile launches move (on the card each execute
    adds one to both: ``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels.gustavson_spgemm import k1_kernel, spgemm_scheduled

    a, b = _operands()
    plan = spgemm_plan(a, b, tile=3, group=1, device="cpu", cache=PlanCache())
    before = (spgemm_scheduled.launches, spgemm_scheduled.small_tile_launches)
    hb.set_tracing(True)
    plan.execute(a.val, b.val)
    hb.set_tracing(False)
    counts = hb.totals()["spans"]["spgemm.execute.launch"]["counts"]
    triples = plan.report.num_triples
    assert triples > 0 and counts == {"pairs": 27 * triples, "triples": triples}
    assert (spgemm_scheduled.launches, spgemm_scheduled.small_tile_launches) == before
    assert [k1_kernel(t) for t in ((3, 3, 3), (1, 1, 1), (8, 2, 8), (16, 16, 16),
                                   (3, 3, 12))] == ["small", "element", "small", "ring", None]


def test_pinned_download_counter_stays_zero_on_a_cpu_plan():
    """On a CPU plan no download goes through page-locked memory:
    ``spgemm.d2h_pinned_bytes`` does not move, while ``spgemm.d2h_bytes``
    and the download span still count C's values."""
    plan, a, b = _plan()
    pinned, d2h = _counter("spgemm.d2h_pinned_bytes"), _counter("spgemm.d2h_bytes")
    hb.set_tracing(True)
    c = plan.execute(a.val, b.val)
    batch = plan.execute_batch(np.stack([a.val] * 2), np.stack([b.val] * 2))
    hb.set_tracing(False)
    nbytes = c.data.nbytes + sum(r.data.nbytes for r in batch)
    assert _counter("spgemm.d2h_pinned_bytes") == pinned
    assert _counter("spgemm.d2h_bytes") - d2h == nbytes > 0
    assert hb.totals()["spans"]["spgemm.execute.download"]["counts"] == {"bytes": nbytes}


def test_totals_sum_self_time_counts_and_the_window():
    rec = hb.SpanRecorder()
    s = 10**9  # ns in a second
    for r in [
        hb.SpanRecord("before", 0, s, 1, 0, 1, None),
        hb.SpanRecord("req", 2 * s, 6 * s, 2, 0, 2, None),
        hb.SpanRecord("req.a", 2 * s, 3 * s, 3, 2, 2, {"bytes": 5}),
        hb.SpanRecord("req.a", 3 * s, 4 * s, 4, 2, 2, {"bytes": 7}),
        hb.SpanRecord("req.b", 3 * s + s // 2, 5 * s, 5, 2, 2, None),
        hb.SpanRecord("after", 7 * s, 9 * s, 6, 0, 6, None),
    ]:
        rec.add(r)
    assert [r.name for r in rec.spans(1.5, 6.5)] == ["req", "req.a", "req.a", "req.b"]
    assert [r.name for r in rec.spans()][::5] == ["before", "after"]
    t = rec.totals(1.5, 6.5)
    assert t["dropped"] == 0 and set(t["spans"]) == {"req", "req.a", "req.b"}
    assert t["spans"]["req"] == {"count": 1, "seconds": 4.0, "self_seconds": 1.0, "counts": {}}
    assert t["spans"]["req.a"] == {"count": 2, "seconds": 2.0, "self_seconds": 2.0,
                                   "counts": {"bytes": 12}}
    assert t["spans"]["req.b"]["seconds"] == 1.5
    assert rec.totals(9.5, 10.0) == {"spans": {}, "dropped": 0}


def test_chip_smoke_reads_the_execute_stages_from_the_spans():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    plan, _, _ = _plan()
    got = chip_smoke.execute_spans(plan, np.random.default_rng(0), reps=2)
    assert set(got) == set(EXECUTE)
    assert all(v["calls"] == 1.0 and v["ms"] >= v["self_ms"] >= 0 for v in got.values())
    assert got["spgemm.execute.upload"]["mb"] == pytest.approx(plan.value_nbytes() / 1e6)
    assert hb.spans() and not hb.default_recorder().forced
