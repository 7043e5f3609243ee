"""The reader ``assembly_on_device.oneshot``: the ``on_device`` count of the
plan's assembly span per completed request, nothing from a program whose
span counts none, and 0 in a traced CPU run of ``fem14k.oneshot`` cut
small, whose plans build their maps on the host."""
import time
import types

import pytest

from conftest import ROOT, small
from perfbench import manifest as mf
from perfbench.loops import Request
from perfbench.run import correct, metrics, run_cell

MAN = mf.Manifest(ROOT)
NAME = "assembly_on_device.oneshot"


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


def test_the_reader_gives_the_count_per_request_and_nothing_without_it(recorder):
    recorder.set_tracing(True)
    t0 = time.perf_counter()
    for on_device in (1, 1, 0):
        with recorder.span("spgemm.plan.assembly", on_device=on_device):
            pass
    t1 = time.perf_counter()
    with recorder.span("spgemm.plan.assembly"):  # a program that counts nothing
        pass
    t2 = time.perf_counter()
    read = MAN.reader(NAME)
    assert read(_run(t0, t1, 2)) == pytest.approx(1.0)
    assert read(_run(t0, t1, 3)) == pytest.approx(2 / 3)
    assert read(_run(t1, t2, 1)) is None


def test_the_manifest_lists_the_metric_for_the_oneshot_cell_only():
    entry = next(m for m in MAN.data["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["fem14k.oneshot"] and entry["moves"] == "requests_per_s"
    assert entry["layer"] == "symbolic phase" and entry["better"] == "higher"
    assert NAME in {m["name"] for m in MAN.metrics("fem14k.oneshot", trace=True)}
    assert NAME not in {m["name"] for m in MAN.metrics("graph130k.execute", trace=True)}


def test_a_traced_small_oneshot_run_on_the_cpu_reads_0(recorder):
    cell = {"name": "fem14k.oneshot", "config": "fem14k", "traffic": "oneshot", "chips": 1}
    record, checks, _, _ = run_cell(
        MAN, cell, 2_147_493_301, 0.6, True, "cpu", time.perf_counter(),
        config=small(MAN.config("fem14k"), 0.1), traffic=MAN.traffic("oneshot"))
    assert correct(checks), checks
    got = metrics(MAN, "fem14k.oneshot", record, True)
    assert got[NAME] == {"value": 0.0, "unit": "plans/req"}
    assert got["assembly_ms.oneshot"]["value"] > 0
