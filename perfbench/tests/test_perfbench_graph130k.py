"""The cell ``graph130k.execute``: its entries in ``BENCHMARK.json``, the
sizes its configuration states, a small run of it on the CPU (correct, its
control not, its span metrics read), and a program that rejects
``output="exact"`` failing its set-up before any symbolic work."""
import json
import time

import numpy as np
import pytest

from conftest import ROOT, small
from perfbench import gen, manifest as mf, work
from perfbench.run import correct, metrics, run_cell

MAN = mf.Manifest(ROOT)
CELL = "graph130k.execute"
# The cell shares the execute path's metrics with fem101k.execute; only the
# count of pairs per launch is its own.
SPANS = {"rebind_ms.execute", "upload_ms.execute", "launch_ms.execute",
         "download_ms.execute", "wrap_ms.execute", "d2h_mb.execute", "launch_pairs_m.exact"}
PER_LAYER = SPANS | {"dtoh_ms.execute", "kernels_roofline.execute",
                     "device_idle_pct.closed", "request_mfu_pct.closed"}
OWN = {"launch_pairs_m.exact"}
SCALE, SECONDS = 0.02, 0.6


@pytest.fixture
def recorder():
    from repro_torch.runtime import heartbeat as hb

    hb.set_tracing(False)
    hb.default_recorder().clear()
    yield hb
    hb.set_tracing(False)
    hb.default_recorder().clear()


def _config():
    return MAN.config(MAN.cell(CELL)["config"])


def test_the_manifest_lists_the_cell_and_its_metrics():
    cell = MAN.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("graph130k", "execute", 1)
    assert {m["name"] for m in MAN.metrics(CELL, trace=False)} == {"setup_s", "requests_per_s"}
    assert {m["name"] for m in MAN.metrics(CELL, trace=True)} == PER_LAYER
    for m in MAN.data["per_layer"]:
        if m["name"] in PER_LAYER:
            assert m["workloads"][-1] == CELL and m["moves"] == "requests_per_s"
            assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"] in OWN:
            assert m["workloads"] == [CELL]
    assert PER_LAYER - OWN <= {m["name"] for m in MAN.metrics("fem101k.execute", trace=True)}
    for other in ("fem101k.execute", "fem14k.oneshot"):
        assert not OWN & {m["name"] for m in MAN.metrics(other, trace=True)}
    entry = next(c for c in MAN.data["configs"] if c["name"] == "graph130k")
    assert entry["reduced"] == [] and entry["source"] == _config()["source"]


def test_the_configuration_states_what_the_program_runs():
    cfg = _config()
    assert (cfg["tile"], cfg["group"], cfg["output"]) == (1, 1, "exact")
    assert cfg["value_dtype"] == "float32" and cfg["system"] == "spgemm"
    assert cfg["assumed"] and 0 < cfg["limits"]["c_err"] < 1e-3
    assert cfg["table4"]["matrix"] == "cage12"


def test_sizes_are_what_gen_and_work_count():
    """A's nonzeros from ``gen.matrix``, A·A's pairs from ``work``'s count,
    and the exact C's entries counted row block by row block."""
    cfg = _config()
    a = gen.matrix(cfg["matrices"]["A"])
    assert a.nnz == cfg["sizes"]["A_nnz"] == 2_028_000
    assert work.product_flops(a, a) == 2 * cfg["sizes"]["AA_pairs"]
    n = a.shape[1]
    indptr = np.zeros(a.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(a.row, minlength=a.shape[0]), out=indptr[1:])
    entries = 0
    for lo in range(0, a.shape[0], 16_384):
        sl = slice(indptr[lo], indptr[min(lo + 16_384, a.shape[0])])
        row, col = a.row[sl].astype(np.int64), a.col[sl].astype(np.int64)
        counts = indptr[col + 1] - indptr[col]
        first = np.cumsum(counts) - counts
        pos = np.repeat(indptr[col] - first, counts) + np.arange(int(counts.sum()))
        entries += np.unique(np.repeat(row, counts) * n + a.col[pos]).shape[0]
    assert entries == cfg["sizes"]["AA_exact_c_nnz"]


def _run(seed, trace):
    cell = MAN.cell(CELL)
    return run_cell(MAN, cell, seed, SECONDS, trace, "cpu", time.perf_counter(),
                    config=small(_config(), SCALE))


def test_a_small_run_is_correct_and_its_control_is_not():
    _, checks, compared, _ = _run(2_147_483_659, False)
    assert compared > 0 and correct(checks), checks
    cfg = small(_config(), SCALE)
    traffic = MAN.traffic("execute")
    sut = mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 5, "cpu")
    _, kept, _, _ = mf.loop(traffic["loop"]).run(sut, traffic, SECONDS, 5)
    sut.release()
    program, _ = sut.check(kept)
    control, _ = sut.check(kept, control=True)
    assert program["c_err"] < cfg["limits"]["c_err"] < control["c_err"]


def test_a_traced_small_run_reads_its_span_metrics(recorder):
    record, checks, _, _ = _run(2_147_491_003, True)
    assert correct(checks), checks
    got = metrics(MAN, CELL, record, True)
    assert SPANS <= set(got) and set(got) <= PER_LAYER
    assert all(got[m]["value"] > 0 for m in SPANS)
    a = gen.matrix(small(_config(), SCALE)["matrices"]["A"])
    assert got["launch_pairs_m.exact"]["value"] == pytest.approx(
        work.product_flops(a, a) / 2 / 1e6, rel=1e-12)


def test_a_program_that_rejects_exact_output_fails_set_up_at_once(monkeypatch):
    """The program before ``output="exact"`` refused it in the first lines
    of ``spgemm_plan``: the cell's set-up raises there, with no schedule
    built and no symbolic span recorded."""
    from repro_torch.runtime import heartbeat as hb
    from repro_torch.spgemm import plan as plan_mod
    from repro_torch.spgemm import schedule_build_count

    def parent_check(output):
        if output not in ("block", "compact"):
            raise ValueError(f"output must be 'block' or 'compact', got {output!r}")

    monkeypatch.setattr(plan_mod, "_check_output", parent_check)
    hb.default_recorder().clear()
    hb.set_tracing(True)
    builds = schedule_build_count()
    cfg, traffic = small(_config(), SCALE), MAN.traffic("execute")
    try:
        with pytest.raises(ValueError, match="output must be"):
            mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 3, "cpu")
        names = {r.name for r in hb.spans()}
    finally:
        hb.set_tracing(False)
        hb.default_recorder().clear()
    assert schedule_build_count() == builds
    assert not names & {"spgemm.plan.inputs", "spgemm.plan.schedule", "spgemm.plan.stage"}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_the_card(card, trace):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", CELL, "--seed",
         str(2**31 + 29), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["k1_launch_gap"]["value"] == 0
    if trace:
        assert set(result["metrics"]) == PER_LAYER
        assert result["metrics"]["launch_pairs_m.exact"]["value"] == pytest.approx(31.626383)
    else:
        assert set(result["metrics"]) == {"setup_s", "requests_per_s"}
