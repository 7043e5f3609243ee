"""The reader ``input_sorts.oneshot``: the sorts counted on the plan's
inputs span per completed request, nothing from a program whose span counts
none, and 0 in a traced CPU run of ``fem14k.oneshot`` cut small, whose
operands are canonical and are A passed as both sides."""
import time
import types

import pytest

from conftest import ROOT, small
from perfbench import manifest as mf
from perfbench.loops import Request
from perfbench.run import correct, metrics, run_cell

MAN = mf.Manifest(ROOT)
NAME = "input_sorts.oneshot"


@pytest.fixture
def recorder():
    from repro_torch.runtime import heartbeat as hb

    hb.set_tracing(False)
    hb.default_recorder().clear()
    yield hb
    hb.set_tracing(False)
    hb.default_recorder().clear()


def _run(t0, t1, done):
    return types.SimpleNamespace(
        t0=t0, t1=t1, requests=[Request(i, "AA", t0, t0, t1, True, "ok") for i in range(done)])


def test_the_reader_gives_sorts_per_request_and_nothing_without_the_count(recorder):
    recorder.set_tracing(True)
    t0 = time.perf_counter()
    for sorts in (2, 1, 0):
        with recorder.span("spgemm.plan.inputs", sorts=sorts):
            pass
    t1 = time.perf_counter()
    with recorder.span("spgemm.plan.inputs"):  # a program that counts no sorts
        pass
    t2 = time.perf_counter()
    read = MAN.reader(NAME)
    assert read(_run(t0, t1, 2)) == pytest.approx(1.5)
    assert read(_run(t1, t2, 1)) is None


def test_the_manifest_lists_the_metric_for_the_oneshot_cell_only():
    entry = next(m for m in MAN.data["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["fem14k.oneshot"] and entry["moves"] == "requests_per_s"
    assert entry["layer"] == "symbolic phase"
    assert NAME in {m["name"] for m in MAN.metrics("fem14k.oneshot", trace=True)}
    assert NAME not in {m["name"] for m in MAN.metrics("fem101k.execute", trace=True)}


def test_a_traced_small_oneshot_run_reads_no_sorts(recorder):
    cell = {"name": "fem14k.oneshot", "config": "fem14k", "traffic": "oneshot", "chips": 1}
    record, checks, _, _ = run_cell(
        MAN, cell, 2_147_491_003, 0.6, True, "cpu", time.perf_counter(),
        config=small(MAN.config("fem14k"), 0.1), traffic=MAN.traffic("oneshot"))
    assert correct(checks), checks
    got = metrics(MAN, "fem14k.oneshot", record, True)
    assert got[NAME] == {"value": 0.0, "unit": "sorts"}
    assert got["inputs_ms.oneshot"]["value"] > 0
