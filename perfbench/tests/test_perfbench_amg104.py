"""The cell ``amg104.galerkin``: its entries in ``BENCHMARK.json``; the
frozen generator (``perfbench/stencil.py``) against the sequential greedy
aggregation and against hand counts of its sizes; a small run on the CPU
(correct, its control not, its span metrics read); planted faults; and a
program that refuses exact chains failing its set-up at once."""
import itertools
import json
import time

import numpy as np
import pytest

from conftest import ROOT
from perfbench import manifest as mf
from perfbench import stencil
from perfbench.run import correct, metrics, run_cell

MAN = mf.Manifest(ROOT)
CELL = "amg104.galerkin"
OWN = {"chain_pairs_m.galerkin", "h2d_mb.galerkin"}
SPANS = OWN | {"download_ms.execute", "d2h_mb.execute"}
PER_LAYER = SPANS | {"kernels_roofline.execute", "device_idle_pct.closed",
                     "request_mfu_pct.closed"}
GRID, SECONDS = 12, 0.6


@pytest.fixture
def recorder():
    from repro_torch.runtime import heartbeat as hb

    hb.set_tracing(False)
    hb.default_recorder().clear()
    yield hb
    hb.set_tracing(False)
    hb.default_recorder().clear()


def _config(grid=None):
    cfg = MAN.config(MAN.cell(CELL)["config"])
    if grid is not None:
        cfg = dict(cfg, grid=grid)
    return cfg


def test_the_manifest_lists_the_cell_and_its_metrics():
    cell = MAN.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("amg104", "galerkin", 1)
    assert {m["name"] for m in MAN.metrics(CELL, trace=False)} == {"setup_s", "requests_per_s"}
    assert {m["name"] for m in MAN.metrics(CELL, trace=True)} == PER_LAYER
    for m in MAN.data["per_layer"]:
        if m["name"] in PER_LAYER:
            assert m["workloads"][-1] == CELL and m["moves"] == "requests_per_s"
            assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"] in OWN:
            assert m["workloads"] == [CELL] and m["source"] == "program_span"
    for other in ("fem101k.execute", "fem14k.oneshot", "graph130k.execute"):
        assert not OWN & {m["name"] for m in MAN.metrics(other, trace=True)}
    entry = next(c for c in MAN.data["configs"] if c["name"] == "amg104")
    assert entry["reduced"] == ["processes"] and entry["source"] == _config()["source"]


def test_the_configuration_states_what_the_program_runs():
    cfg = _config()
    assert (cfg["tile"], cfg["group"], cfg["output"]) == (1, 1, "exact")
    assert cfg["value_dtype"] == "float32" and cfg["system"] == "spgemm"
    assert (cfg["grid"], cfg["processes"], cfg["stencil"]) == (104, 1, 27)
    assert cfg["assumed"] and 0 < cfg["limits"]["c_err"] < 1e-3
    traffic = MAN.traffic("galerkin")
    assert (traffic["entry"], traffic["loop"], traffic["value_sets"]) == ("galerkin", "closed", 4)


def _greedy(n):
    """The two-pass greedy aggregation node by node, as written."""
    a = stencil.stencil(n)
    nbrs = np.split(a.col, np.cumsum(np.bincount(a.row, minlength=n ** 3))[:-1])
    agg = np.full(n ** 3, -1)
    count = 0
    for i in range(n ** 3):
        if (agg[nbrs[i]] < 0).all():
            agg[nbrs[i]] = count
            count += 1
    first = agg.copy()
    for i in np.flatnonzero(first < 0):
        agg[i] = first[nbrs[i]][first[nbrs[i]] >= 0][0]
    return agg, count


@pytest.mark.parametrize("n", [2, 3, 5, 6, 7, 8, 9])
def test_the_aggregation_is_the_sequential_greedy(n):
    got, count = stencil.aggregates(n)
    want, want_count = _greedy(n)
    assert count == want_count and np.array_equal(got, want)


def _dense(p):
    d = np.zeros(p.shape, np.int64)
    d[p.row, p.col] = 1
    return d


@pytest.mark.parametrize("n", [5, 6])
def test_the_matrices_at_a_small_grid_are_a_hand_count(n):
    """A by its coordinates, P by A·P₀ in dense integers, R = Pᵀ entry for
    entry, all canonical; the products' pairs and entries counted densely."""
    r, a, p = stencil.galerkin(n, 3)
    coords = list(itertools.product(range(n), repeat=3))  # (z, y, x), x fastest
    want_a = np.zeros((n ** 3, n ** 3), np.int64)
    for i, ci in enumerate(coords):
        for j, cj in enumerate(coords):
            want_a[i, j] = max(abs(u - v) for u, v in zip(ci, cj)) <= 1
    assert np.array_equal(_dense(a), want_a)
    agg, count = _greedy(n)
    p0 = np.zeros((n ** 3, count), np.int64)
    p0[np.arange(n ** 3), agg] = 1
    assert np.array_equal(_dense(p), (want_a @ p0 > 0).astype(np.int64))
    assert np.array_equal(_dense(r), _dense(p).T)
    dense_p = np.zeros(p.shape)
    dense_p[p.row, p.col] = p.val
    dense_r = np.zeros(r.shape)
    dense_r[r.row, r.col] = r.val
    assert np.array_equal(dense_r, dense_p.T)
    for m in (r, a, p):
        key = m.row.astype(np.int64) * m.shape[1] + m.col
        assert np.all(np.diff(key) > 0)
    ra = _dense(r) @ want_a
    assert int((_dense(r).sum(0) * want_a.sum(1)).sum()) == int(ra.sum())
    assert int(((ra > 0) @ _dense(p)).sum()) == int(((ra > 0).sum(0) * _dense(p).sum(1)).sum())


def test_the_full_grids_sizes_are_the_one_dimensional_counts_cubed():
    """At 104 every node lies in a pass-1 box, so every matrix is the
    Kronecker cube of its 1-D factor (tridiagonal A₁, boxes of 3 in P₀₁),
    and each size the cube of the 1-D count; the generator's own sizes at
    grids 8 and 11 (also not multiples of 3) are the cubes too."""
    def one_d(n):
        a1 = (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 1).astype(np.int64)
        p01 = np.zeros((n, (n - 1) // 3 + 1), np.int64)
        p01[np.arange(n), (np.arange(n) + 1) // 3] = 1
        p1 = (a1 @ p01 > 0).astype(np.int64)
        ra1 = (p1.T @ a1 > 0).astype(np.int64)
        return {"A_nnz": a1.sum(), "aggregates": p01.shape[1], "P_nnz": p1.sum(),
                "RA_pairs": (p1.sum(1) * a1.sum(1)).sum(), "RA_exact_c_nnz": ra1.sum(),
                "RAP_pairs": (ra1.sum(0) * p1.sum(1)).sum(),
                "RAP_exact_c_nnz": (ra1 @ p1 > 0).sum()}

    sizes = _config()["sizes"]
    for key, v in one_d(104).items():
        assert sizes[key] == int(v) ** 3, key
    assert sizes["rows"] == 104 ** 3 and sizes["R_nnz"] == sizes["P_nnz"]
    assert sizes["chain_pairs"] == sizes["RA_pairs"] + sizes["RAP_pairs"] == 188_954_120
    for n in (8, 11):
        r, a, p = stencil.galerkin(n, 1)
        want = one_d(n)
        assert (a.nnz, p.nnz, r.shape[0]) == (want["A_nnz"] ** 3, want["P_nnz"] ** 3,
                                              want["aggregates"] ** 3)


def _run(seed, trace, grid=GRID, seconds=SECONDS):
    return run_cell(MAN, MAN.cell(CELL), seed, seconds, trace, "cpu", time.perf_counter(),
                    config=_config(grid))


def test_a_small_run_is_correct_and_its_control_is_not():
    _, checks, compared, _ = _run(2_147_483_731, False)
    assert compared > 0 and correct(checks), checks
    assert checks["c_err"]["value"] < checks["c_err"]["limit"] / 10
    cfg, traffic = _config(GRID), MAN.traffic("galerkin")
    sut = mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 5, "cpu")
    _, kept, _, _ = mf.loop(traffic["loop"]).run(sut, traffic, SECONDS, 5)
    sut.release()
    program, _ = sut.check(kept)
    control, _ = sut.check(kept, control=True)
    assert program["c_err"] < cfg["limits"]["c_err"] < control["c_err"]
    assert program["c_missing"] == program["c_extra"] == program["c_structure"] == 0


def test_each_request_brings_its_own_values():
    cfg, traffic = _config(5), MAN.traffic("galerkin")
    sut = mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 6, "cpu")
    sets = int(traffic["value_sets"])
    first, again = sut.values(0), sut.values(sets)
    assert first.data_ptr() != again.data_ptr() and int((first != again).sum()) <= 2
    assert bool((sut.values(3) == sut.values(3)).all())
    sut.release()


def test_a_traced_small_run_reads_its_span_metrics(recorder):
    record, checks, _, _ = _run(2_147_491_019, True)
    assert correct(checks), checks
    got = metrics(MAN, CELL, record, True)
    assert SPANS <= set(got) and set(got) <= PER_LAYER
    r, a, p = stencil.galerkin(GRID, 1)
    from perfbench.reference import ExactProduct

    ra = ExactProduct(r, a, "cpu")
    assert got["chain_pairs_m.galerkin"]["value"] == pytest.approx(
        (ra.pairs + _rap_pairs(ra, p)) / 1e6, rel=1e-12)
    # A CPU plan's values are host values: its upload span counts A's bytes.
    assert got["h2d_mb.galerkin"]["value"] == pytest.approx(4 * a.nnz / 1e6, rel=1e-12)


def _rap_pairs(ra, p):
    n = ra.shape[1]
    cols = (ra.keys % n).numpy()
    return int((np.bincount(cols, minlength=n) * np.bincount(p.row, minlength=n)).sum())


def _stage_stale(stage):
    def plant(monkeypatch):
        """Stage ``stage`` of the chain computed once: every later request
        reuses its first output."""
        from repro_torch.spgemm import SpGEMMPlan

        name = "_run_packed" if stage == 1 else "_run_packed_chained"
        real, first = getattr(SpGEMMPlan, name), {}

        def run(self, *args, **kw):
            out = real(self, *args, **kw)
            return first.setdefault(id(self), out)

        monkeypatch.setattr(SpGEMMPlan, name, run)
    return plant


def _cached(monkeypatch):
    """Results cached by a sample of A's values: a request whose sampled
    value was seen before is answered without a product."""
    import repro_torch.spgemm as spgemm

    memo, real = {}, spgemm.execute_chain

    def execute_chain(chain, a_vals=None, b_vals=None):
        key = float(b_vals[-1])
        if key not in memo:
            memo[key] = real(chain, a_vals, b_vals)
        return memo[key]

    monkeypatch.setattr(spgemm, "execute_chain", execute_chain)


def _altered(monkeypatch):
    """A_c's largest value off by 0.1 %, where it is produced."""
    from repro_torch.spgemm import SpGEMMPlan

    real = SpGEMMPlan._wrap_packed

    def wrap(self, packed):
        packed = packed.clone()
        packed[int(packed.abs().argmax())] *= 1.001
        return real(self, packed)

    monkeypatch.setattr(SpGEMMPlan, "_wrap_packed", wrap)


@pytest.mark.parametrize("fault", [_stage_stale(1), _stage_stale(2), _cached, _altered],
                         ids=["stage1_stale", "stage2_stale", "cached", "altered"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    """Each fault answers every request after the warm-up's (-1, -2, of
    value sets 3 and 2) wrongly, except at most requests 0 and 1 (sets 0
    and 1, the first of theirs): with five requests or more, the sample of
    3 holds a wrong one. At grid 5 a 2 s window holds dozens."""
    fault(monkeypatch)
    record, checks, compared, _ = _run(13, False, grid=5, seconds=2.0)
    assert len(record.requests) >= 5 and compared == 3
    assert not correct(checks), checks


def test_a_program_that_refuses_exact_chains_fails_set_up_at_once(monkeypatch):
    """The program before exact chains refused them in ``then``: the cell's
    set-up raises there, on its first one-entry chain, before the
    generator runs or the full product's symbolic phase."""
    from repro_torch.spgemm import SpGEMMPlan, schedule_build_count
    from repro_torch.spgemm.plan import _not_served

    real = SpGEMMPlan._plan_next

    def parent_plan_next(self, b, **kwargs):
        if self.output == "exact":
            raise _not_served("chains")
        return real(self, b, **kwargs)

    monkeypatch.setattr(SpGEMMPlan, "_plan_next", parent_plan_next)
    called = []
    monkeypatch.setattr(stencil, "galerkin", lambda *a: called.append(a))
    builds = schedule_build_count()
    cfg, traffic = _config(), MAN.traffic("galerkin")
    t = time.perf_counter()
    with pytest.raises(ValueError, match="do not serve chains"):
        mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 3, "cpu")
    assert time.perf_counter() - t < 5
    assert not called and schedule_build_count() == builds + 1


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_the_card(card, trace):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", CELL, "--seed",
         str(2**31 + 31), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["k1_launch_gap"]["value"] == 0
    if trace:
        assert set(result["metrics"]) == PER_LAYER
        assert result["metrics"]["chain_pairs_m.galerkin"]["value"] == pytest.approx(188.95412)
        assert result["metrics"]["h2d_mb.galerkin"]["value"] == 0.0
    else:
        assert set(result["metrics"]) == {"setup_s", "requests_per_s"}
