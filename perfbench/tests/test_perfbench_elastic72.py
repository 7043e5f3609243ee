"""The cell ``elastic72.galerkin_blocks``: its entries in ``BENCHMARK.json``;
the frozen generator (``perfbench/elastic.py``) against dense Kronecker
products of the nodal patterns, and its stated sizes at 72³ from the nodal
counts; the chunked plain reference against itself in one chunk and
against two chained ``reference.ExactProduct``; a small run on the CPU
(correct, its TF32 control not, its span metrics read); planted faults;
and a program that refuses small tiles failing its set-up at once."""
import json
import time

import numpy as np
import pytest

from conftest import ROOT
from perfbench import elastic, gen, reference, stencil
from perfbench import manifest as mf
from perfbench.run import correct, metrics, run_cell
from perfbench.systems.spgemm.galerkin_blocks import ChainReference

MAN = mf.Manifest(ROOT)
CELL = "elastic72.galerkin_blocks"
OWN = {"chain_triples_m.galerkin_blocks", "small_tile_roofline.galerkin_blocks"}
SHARED = {"chain_pairs_m.galerkin", "h2d_mb.galerkin", "rebind_ms.execute",
          "upload_ms.execute", "launch_ms.execute", "download_ms.execute", "wrap_ms.execute",
          "d2h_mb.execute", "dtoh_ms.execute", "kernels_roofline.execute",
          "device_idle_pct.closed", "request_mfu_pct.closed"}
SPANS = {"chain_triples_m.galerkin_blocks", "chain_pairs_m.galerkin", "h2d_mb.galerkin",
         "rebind_ms.execute", "upload_ms.execute", "launch_ms.execute", "download_ms.execute",
         "wrap_ms.execute", "d2h_mb.execute"}
PER_LAYER = OWN | SHARED
GRID, SECONDS = 5, 0.6


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
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("elastic72", "galerkin_blocks", 1)
    assert {m["name"] for m in MAN.metrics(CELL, trace=False)} == {"setup_s", "requests_per_s"}
    assert {m["name"] for m in MAN.metrics(CELL, trace=True)} == PER_LAYER
    for m in MAN.data["per_layer"]:
        if m["name"] in PER_LAYER:
            assert CELL in m["workloads"] and m["moves"] == "requests_per_s"
            assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"] in OWN:
            assert m["workloads"] == [CELL] and m["layer"] == "kernels"
    for other in ("fem101k.execute", "fem14k.oneshot", "graph130k.execute", "amg104.galerkin"):
        assert not OWN & {m["name"] for m in MAN.metrics(other, trace=True)}
    entry = next(c for c in MAN.data["configs"] if c["name"] == "elastic72")
    assert entry["reduced"] == ["processes"] and entry["source"] == _config()["source"]


def test_the_configuration_states_what_the_program_runs():
    cfg = _config()
    assert (cfg["tile"], cfg["group"], cfg["output"]) == (3, 1, "block")
    assert cfg["value_dtype"] == "float32" and cfg["system"] == "spgemm"
    assert (cfg["grid"], cfg["processes"], cfg["stencil"]) == (72, 1, 27)
    assert (cfg["dofs_per_node"], cfg["rigid_body_modes"]) == (elastic.DOFS, elastic.MODES)
    assert cfg["assumed"] and 0 < cfg["limits"]["c_err"] < 1e-3
    traffic = MAN.traffic("galerkin_blocks")
    assert (traffic["entry"], traffic["loop"], traffic["value_sets"], traffic["sample"]) == (
        "galerkin_blocks", "closed", 4, 3)


def _dense(p):
    d = np.zeros(p.shape, np.int64)
    d[p.row, p.col] = 1
    return d


@pytest.mark.parametrize("n", [3, 4, 6])
def test_the_matrices_are_the_nodal_patterns_times_dense_blocks(n):
    """A = the 27-point stencil ⊗ 3 x 3 ones, P = the prolongator's pattern
    ⊗ 3 x 6 ones, R = Pᵀ entry for entry, all canonical; values from the
    seed, the same for the same seed."""
    r, a, p = elastic.galerkin(n, 7)
    a_node, p_node = elastic.nodal(n)
    assert np.array_equal(_dense(a), np.kron(_dense(a_node), np.ones((3, 3), np.int64)))
    assert np.array_equal(_dense(p), np.kron(_dense(p_node), np.ones((3, 6), np.int64)))
    dense_p = np.zeros(p.shape)
    dense_p[p.row, p.col] = p.val
    dense_r = np.zeros(r.shape)
    dense_r[r.row, r.col] = r.val
    assert np.array_equal(dense_r, dense_p.T)
    for m in (r, a, p):
        key = m.row.astype(np.int64) * m.shape[1] + m.col
        assert np.all(np.diff(key) > 0) and m.row.dtype == m.col.dtype == np.int32
        assert m.val.dtype == np.float32 and np.all(m.val != 0)
    r2, a2, p2 = elastic.galerkin(n, 7)
    assert np.array_equal(a.val, a2.val) and np.array_equal(p.val, p2.val)
    assert np.array_equal(a.val, elastic.a_values(7, 0, a.nnz).numpy())
    assert not np.array_equal(elastic.a_values(7, 1, a.nnz).numpy(), a.val)


def _nodal_counts(n, chunk_pairs=1 << 24):
    a_node, p_node = elastic.nodal(n)
    ref = ChainReference(stencil.transpose(p_node), a_node, p_node, "cpu", chunk_pairs)
    ref.run([])
    return a_node, p_node, ref


@pytest.mark.parametrize("n", [4, 6])
def test_element_counts_are_the_nodal_counts_times_the_block_factors(n):
    """Each nodal pair of R·A is 6·3·3 scalar products and 2 tile-3
    triples, each of (R·A)·P 6·3·6 and 4; each nodal entry of R·A holds 18
    scalar entries, of A_c 36: the element reference and the tile-3 plans
    count so."""
    import repro_torch.spgemm as spgemm
    from perfbench.systems.spgemm import coo

    _, _, node = _nodal_counts(n)
    r, a, p = elastic.galerkin(n, 1)
    elem = ChainReference(r, a, p, "cpu")
    elem.run([])
    assert (elem.pairs1, elem.pairs2) == (54 * node.pairs1, 108 * node.pairs2)
    assert (elem.mid_nnz, elem.pattern.nnz) == (18 * node.mid_nnz, 36 * node.pattern.nnz)
    chain = spgemm.spgemm_plan(coo(r), coo(a), tile=3, group=1, device="cpu",
                               cache=spgemm.PlanCache()).then(coo(p), cache=spgemm.PlanCache())
    assert [q.report.num_triples for q in chain.plans] == [2 * node.pairs1, 4 * node.pairs2]
    assert chain.plans[1].report.nnz_a == elem.mid_nnz
    assert chain.plans[1].assembly.nnz == elem.pattern.nnz


def test_the_stated_sizes_at_72_are_the_nodal_counts_times_the_block_factors():
    sizes = _config()["sizes"]
    a_node, p_node, node = _nodal_counts(72)
    want = {
        "nodes": 72 ** 3, "rows": 3 * 72 ** 3, "A_node_blocks": a_node.nnz,
        "A_nnz": 9 * a_node.nnz, "aggregates": p_node.shape[1],
        "coarse_rows": 6 * p_node.shape[1], "P_nnz": 18 * p_node.nnz,
        "R_nnz": 18 * p_node.nnz, "P_tiles": 2 * p_node.nnz,
        "RA_triples": 2 * node.pairs1, "RA_pairs": 54 * node.pairs1,
        "RA_exact_c_nnz": 18 * node.mid_nnz, "RAP_triples": 4 * node.pairs2,
        "RAP_pairs": 108 * node.pairs2, "RAP_exact_c_nnz": 36 * node.pattern.nnz,
        "RAP_tiles": 4 * node.pattern.nnz,
        "chain_triples": 2 * node.pairs1 + 4 * node.pairs2,
        "chain_pairs": 54 * node.pairs1 + 108 * node.pairs2,
    }
    assert sizes == want
    assert sizes["chain_triples"] == 157_315_428 and sizes["chain_pairs"] == 4_247_516_556


def test_the_chunked_reference_is_the_one_chunk_reference_and_two_exact_products():
    """Chunks of a few rows give the one-chunk result bitwise; both equal
    R·A then (R·A)·P by ``reference.ExactProduct`` in float64, and the
    control chains TF32 operands as the galerkin entry's control does."""
    r, a, p = elastic.galerkin(4, 11)
    sets = [elastic.a_values(11, j, a.nnz).numpy() for j in range(2)]
    whole = ChainReference(r, a, p, "cpu")
    parts = ChainReference(r, a, p, "cpu", chunk_pairs=500)
    assert len(whole.entry_bounds) == 1 and len(parts.entry_bounds) > 5
    got_whole = whole.run(sets, control=True)
    got_parts = parts.run(sets, control=True)
    assert np.array_equal(whole.pattern.keys.numpy(), parts.pattern.keys.numpy())
    for (c1, s1, t1), (c2, s2, t2) in zip(got_whole, got_parts):
        assert np.array_equal(c1.numpy(), c2.numpy()) and np.array_equal(s1.numpy(), s2.numpy())
        assert np.array_equal(t1, t2)
    ra = reference.ExactProduct(r, a, "cpu")
    n = ra.shape[1]
    rows = (ra.keys // n).numpy().astype(np.int32)
    rap = reference.ExactProduct(gen.Pattern(rows, (ra.keys % n).numpy().astype(np.int32),
                                             None, ra.shape), p, "cpu")
    assert np.array_equal(rap.keys.numpy(), whole.pattern.keys.numpy())
    assert whole.pairs == ra.pairs + rap.pairs and whole.mid_nnz == ra.nnz
    for av, (c, s, _) in zip(sets, got_whole):
        c_ra, s_ra = ra.values(r.val, av)
        c_rap, _ = rap.values(c_ra.numpy(), p.val)
        s_rap, _ = rap.values(s_ra.numpy(), np.abs(p.val))
        np.testing.assert_allclose(c.numpy(), c_rap.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(s.numpy(), s_rap.numpy(), rtol=1e-12, atol=1e-12)


def _run(seed, trace, grid=GRID, seconds=SECONDS):
    return run_cell(MAN, MAN.cell(CELL), seed, seconds, trace, "cpu", time.perf_counter(),
                    config=_config(grid))


def test_a_small_run_is_correct_and_its_control_is_not():
    _, checks, compared, _ = _run(2_147_483_777, False)
    assert compared > 0 and correct(checks), checks
    assert checks["c_err"]["value"] < checks["c_err"]["limit"] / 10
    cfg, traffic = _config(GRID), MAN.traffic("galerkin_blocks")
    sut = mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 5, "cpu")
    _, kept, _, _ = mf.loop(traffic["loop"]).run(sut, traffic, SECONDS, 5)
    sut.release()
    program, _ = sut.check(kept)
    control, _ = sut.check(kept, control=True)
    assert program["c_err"] < cfg["limits"]["c_err"] < control["c_err"]
    assert program["c_missing"] == program["c_extra"] == program["c_structure"] == 0
    assert control["c_missing"] == control["c_extra"] == control["c_structure"] == 0


def test_a_traced_small_run_reads_its_span_metrics(recorder):
    record, checks, _, _ = _run(2_147_491_021, True)
    assert correct(checks), checks
    got = metrics(MAN, CELL, record, True)
    assert SPANS <= set(got) and set(got) <= PER_LAYER
    _, _, node = _nodal_counts(GRID)
    assert got["chain_triples_m.galerkin_blocks"]["value"] == pytest.approx(
        (2 * node.pairs1 + 4 * node.pairs2) / 1e6, rel=1e-12)
    assert got["chain_pairs_m.galerkin"]["value"] == pytest.approx(
        (54 * node.pairs1 + 108 * node.pairs2) / 1e6, rel=1e-12)
    assert got["d2h_mb.execute"]["value"] == pytest.approx(4 * 36 * node.pattern.nnz / 1e6)
    # A CPU plan's values are host values: its upload span counts A's bytes.
    a_nnz = 9 * (3 * GRID - 2) ** 3
    assert elastic.galerkin(GRID, 1)[1].nnz == a_nnz
    assert got["h2d_mb.galerkin"]["value"] == pytest.approx(4 * a_nnz / 1e6, rel=1e-12)


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
    """Results cached by a sample of A's values."""
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


def _tf32(monkeypatch):
    """The chain one precision down: A's values rounded to TF32 before the
    product, as a program that stepped down to TF32 operands would."""
    import repro_torch.spgemm as spgemm

    real = spgemm.execute_chain

    def execute_chain(chain, a_vals=None, b_vals=None):
        return real(chain, a_vals, reference.tf32(b_vals.clone()))

    monkeypatch.setattr(spgemm, "execute_chain", execute_chain)


@pytest.mark.parametrize("fault", [_stage_stale(1), _stage_stale(2), _cached, _altered, _tf32],
                         ids=["stage1_stale", "stage2_stale", "cached", "altered", "tf32"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    """Each fault answers every request after the warm-up's wrongly,
    except at most requests 0 and 1 (the first of their value sets): with
    five requests or more, the sample of 3 holds a wrong one."""
    fault(monkeypatch)
    record, checks, compared, _ = _run(13, False, grid=4, seconds=2.0)
    assert len(record.requests) >= 5 and compared == 3
    assert not correct(checks), checks


def test_a_program_that_refuses_small_tiles_fails_set_up_at_once(monkeypatch):
    """The program before the small-tile kernel refused tile 3 at its
    launch: the cell's set-up raises there, on its grid-2 probe chain,
    before the full grid's inputs are made or planned."""
    from repro_torch.spgemm import executor, schedule_build_count

    real = executor._run_schedule

    def parent_run_schedule(a_blocks, b_blocks, runs, *, backend):
        if max(a_blocks.shape[1:]) < 16:
            raise ValueError("the CUDA kernel takes tile dims that are multiples of 16 up to "
                             "128; bm=3")
        return real(a_blocks, b_blocks, runs, backend=backend)

    monkeypatch.setattr(executor, "_run_schedule", parent_run_schedule)
    real_galerkin, grids = elastic.galerkin, []

    def galerkin(n, seed, device="cpu"):
        grids.append(n)
        return real_galerkin(n, seed, device)

    monkeypatch.setattr(elastic, "galerkin", galerkin)
    builds = schedule_build_count()
    cfg, traffic = _config(), MAN.traffic("galerkin_blocks")
    t = time.perf_counter()
    with pytest.raises(ValueError, match="multiples of 16"):
        mf.entry(cfg["system"], traffic["entry"])(cfg, traffic, 3, "cpu")
    assert time.perf_counter() - t < 5
    assert grids == [2] and schedule_build_count() == builds + 2


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_the_card(card, trace):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", CELL, "--seed",
         str(2**31 + 37), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["k1_launch_gap"]["value"] == 0
    if trace:
        got = result["metrics"]
        assert set(got) == PER_LAYER
        assert got["chain_triples_m.galerkin_blocks"]["value"] == pytest.approx(157.315428)
        assert got["chain_pairs_m.galerkin"]["value"] == pytest.approx(4247.516556)
        assert got["h2d_mb.galerkin"]["value"] == 0.0
        assert got["d2h_mb.execute"]["value"] == pytest.approx(52.452288)
        assert 0 < got["small_tile_roofline.galerkin_blocks"]["value"] <= 100
    else:
        assert set(result["metrics"]) == {"setup_s", "requests_per_s"}
