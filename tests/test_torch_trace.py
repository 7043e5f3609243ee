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
from repro_torch.sparse.random import random_coo
from repro_torch.spgemm import PlanCache, spgemm_plan

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


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("staged", [False, True])
def test_bytes_are_the_bytes_copied(traced, staged):
    """``bytes`` of the upload and the download, and the process-level
    counters (which count traced or not), are the nbytes of the tensors
    that cross: the float32 values (or the packed blocks) in, C's values
    out."""
    plan, a, b = _plan()
    a_vals = np.random.default_rng(1).standard_normal(a.nnz)  # float64, copied as float32
    b_vals = np.random.default_rng(2).standard_normal(b.nnz)
    if staged:
        plan.execute(a_vals, b_vals)  # the host blocks now hold these values
        plan._a_dev = plan._b_dev = None
        want_in = plan._a_blocks.nbytes + plan._b_blocks.nbytes
    else:
        want_in = (torch.from_numpy(a_vals.astype(np.float32)).nbytes
                   + torch.from_numpy(b_vals.astype(np.float32)).nbytes)
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
