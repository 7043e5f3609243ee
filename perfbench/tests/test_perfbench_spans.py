"""The readers of the program's spans: the window, the cases that give
``None``, and a traced CPU run of each cell, cut small, that yields every
metric of its layer."""
import time
import types

import pytest

from conftest import ROOT, small
from perfbench import manifest as mf
from perfbench import spans
from perfbench.loops import Request
from perfbench.run import correct, metrics, run_cell

MAN = mf.Manifest(ROOT)
# Cell -> (configuration, traffic, configuration scale, window seconds).
CELLS = {
    "fem101k.execute": ("fem101k", "execute", 0.02, 0.6),
    "fem14k.oneshot": ("fem14k", "oneshot", 0.1, 0.6),
}
NEW = {
    "fem101k.execute": {"rebind_ms.execute", "upload_ms.execute", "launch_ms.execute",
                        "download_ms.execute", "wrap_ms.execute", "d2h_mb.execute"},
    "fem14k.oneshot": {"inputs_ms.oneshot", "convert_ms.oneshot", "schedule_ms.oneshot",
                       "assembly_ms.oneshot", "stage_ms.oneshot"},
}


@pytest.fixture
def recorder():
    from repro_torch.runtime import heartbeat as hb

    hb.set_tracing(False)
    hb.default_recorder().clear()
    yield hb
    hb.set_tracing(False)
    hb.default_recorder().clear()


def _span(hb, seconds, nbytes):
    with hb.span("spgemm.execute.download", bytes=nbytes):
        time.sleep(seconds)


def _run(t0, t1, done):
    return types.SimpleNamespace(
        t0=t0, t1=t1, requests=[Request(i, "AA", t0, t0, t1, True, "ok") for i in range(done)])


def test_the_window_holds_only_the_spans_inside_it(recorder):
    recorder.set_tracing(True)
    _span(recorder, 0.03, 1_000_000)  # before
    t0 = time.perf_counter()
    _span(recorder, 0.01, 2_000_000)
    _span(recorder, 0.01, 4_000_000)
    t1 = time.perf_counter()
    _span(recorder, 0.03, 8_000_000)  # after
    run = _run(t0, t1, 2)
    inside = recorder.spans(t0, t1)
    assert len(inside) == 2
    want_ms = sum(r.end_ns - r.start_ns for r in inside) / 1e6 / 2
    assert spans.per_request(run, "spgemm.execute.download") == pytest.approx(want_ms)
    assert 10 <= want_ms < 30
    assert spans.per_request(run, "spgemm.execute.download", count="bytes",
                             scale=1e-6) == pytest.approx(3.0)
    assert MAN.reader("d2h_mb.execute")(run) == pytest.approx(3.0)
    assert MAN.reader("download_ms.execute")(run) == pytest.approx(want_ms)


def test_none_when_the_window_is_empty_or_spans_were_dropped(recorder):
    recorder.set_tracing(True)
    t0 = time.perf_counter()
    _span(recorder, 0.0, 1)
    t1 = time.perf_counter()
    assert spans.per_request(_run(t1, t1 + 1.0, 1), "spgemm.execute.download") is None
    assert spans.per_request(_run(t0, t1, 1), "spgemm.execute.wrap") is None
    assert spans.per_request(_run(t0, t1, 0), "spgemm.execute.download") is None
    assert spans.per_request(_run(t0, t1, 1), "spgemm.execute.download", count="x") is None
    assert spans.per_request(_run(t0, t1, 1), "spgemm.execute.download") is not None
    recorder.default_recorder().dropped = 1
    assert spans.per_request(_run(t0, t1, 1), "spgemm.execute.download") is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_traced_run_of_each_cell_yields_its_span_metrics(recorder, name):
    cfg_name, traffic_name, scale, seconds = CELLS[name]
    cell = {"name": name, "config": cfg_name, "traffic": traffic_name, "chips": 1}
    record, checks, _, _ = run_cell(
        MAN, cell, 2_147_491_001, seconds, True, "cpu", time.perf_counter(),
        config=small(MAN.config(cfg_name), scale), traffic=MAN.traffic(traffic_name))
    assert correct(checks), checks
    got = metrics(MAN, name, record, True)
    assert NEW[name] <= set(got)
    assert all(got[m]["value"] > 0 for m in NEW[name])
    listed = {m["name"] for m in MAN.metrics(name, trace=True)}
    assert NEW[name] <= listed and not (NEW[name] & {m["name"] for m in MAN.metrics(
        next(c for c in CELLS if c != name), trace=True)})
