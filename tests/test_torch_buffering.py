"""Port parity: the paper's host models in ``repro_torch`` — OMAR (Eq. 1)
and the buffering scheme's fetch traces (``core/buffering.py``), the
inner- and outer-product baselines and the FSpGEMM simulator
(``core/gustavson.py``), and the paper-matrix config — bit for bit
against ``repro``'s on seeded numpy inputs, as ``tests/test_buffering.py``
and ``tests/test_gustavson.py`` check the reference (including the
latter's hypothesis property of the simulator)."""
import dataclasses

import numpy as np
import pytest
from _compat_hypothesis import given, settings, st

pytest.importorskip("jax")

from repro.configs import paper_matrices as r_paper_matrices  # noqa: E402
from repro.core import buffering as r_buffering  # noqa: E402
from repro.core import gustavson as r_gustavson  # noqa: E402
from repro.sparse import convert as r_convert  # noqa: E402
from repro.sparse.random import random_block_sparse, random_coo, suite_matrix  # noqa: E402
from repro_torch.configs import paper_matrices  # noqa: E402
from repro_torch.core import buffering, gustavson  # noqa: E402
from repro_torch.sparse import convert  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402


def _both(r_coo):
    """The reference COO and the same arrays as a port COO."""
    return COO(r_coo.row, r_coo.col, r_coo.val, r_coo.shape), r_coo


def _same_csr(got, want):
    assert got.shape == want.shape
    for f in ("indptr", "indices", "data"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def _pair(seed, m=40, k=32, n=36, da=0.15, db=0.2):
    a, ra = _both(random_coo(m, k, da, "uniform", seed=seed))
    b, rb = _both(random_coo(k, n, db, "uniform", seed=seed + 1))
    return (convert.to_csr(a), convert.to_csr(b)), (r_convert.to_csr(ra), r_convert.to_csr(rb))


class TestOMAR:
    @settings(max_examples=50, deadline=None)
    @given(seed=st.integers(0, 2000), num_pe=st.integers(1, 32))
    def test_omar_and_trace_equal_reference(self, seed, num_pe):
        a, ra = _both(random_coo(30, 24, 0.15, "uniform", seed=seed))
        a, ra = convert.to_csr(a), r_convert.to_csr(ra)
        assert buffering.omar(a, num_pe) == r_buffering.omar(ra, num_pe)
        assert buffering.omar_from_trace(a, num_pe) == r_buffering.omar_from_trace(ra, num_pe)
        got, want = buffering.b_fetch_trace(a, num_pe), r_buffering.b_fetch_trace(ra, num_pe)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # Eq. 1 and the fetch trace agree, as in the reference.
        assert buffering.omar(a, num_pe) == pytest.approx(buffering.omar_from_trace(a, num_pe))

    @pytest.mark.parametrize("name", ["scircuit", "poisson3Da"])
    def test_paper_matrices_omar_curve(self, name):
        a = suite_matrix(name, scale=0.01)
        pa = convert.to_csr(COO(*_coo_arrays(a)))
        for p in (1, 2, 4, 8, 16, 32):
            assert buffering.omar(pa, p) == r_buffering.omar(a, p)

    def test_csv_input_and_empty(self):
        a, ra = _both(random_coo(50, 50, 0.1, "uniform", seed=3))
        csv, r_csv = convert.to_csv(a, 4), r_convert.to_csv(ra, 4)
        assert buffering.omar(csv, 4) == r_buffering.omar(r_csv, 4)
        empty = convert.to_csr(np.zeros((4, 6), np.float32))
        assert buffering.omar(empty, 2) == 0.0 and buffering.b_fetch_trace(empty, 2).size == 0


def _coo_arrays(csr):
    coo = csr.to_coo()
    return coo.row, coo.col, coo.val, coo.shape


class TestBlockOMAR:
    @pytest.mark.parametrize("group", [1, 2, 4])
    @pytest.mark.parametrize("seed", [5, 9])
    def test_block_omar_and_trace_equal_reference(self, group, seed):
        ad = random_block_sparse(128, 96, (16, 16), 0.3, seed=seed)
        a, ra = convert.to_bcsv(ad, (16, 16), group), r_convert.to_bcsv(ad, (16, 16), group)
        assert buffering.block_omar(a) == r_buffering.block_omar(ra)
        got, want = buffering.block_b_fetch_trace(a), r_buffering.block_b_fetch_trace(ra)
        assert got.dtype == want.dtype and np.array_equal(got, want)


class TestAlgorithms:
    @pytest.mark.parametrize("seed", [7, 8])
    def test_inner_outer_equal_reference(self, seed):
        (a, b), (ra, rb) = _pair(seed, m=20, k=16, n=18)
        c_in, st_in = gustavson.spgemm_inner(a, convert.to_csc(b))
        r_in, rst_in = r_gustavson.spgemm_inner(ra, r_convert.to_csc(rb))
        _same_csr(c_in, r_in)
        assert dataclasses.asdict(st_in) == dataclasses.asdict(rst_in)
        c_out, st_out = gustavson.spgemm_outer(convert.to_csc(a), b)
        r_out, rst_out = r_gustavson.spgemm_outer(r_convert.to_csc(ra), rb)
        _same_csr(c_out, r_out)
        assert dataclasses.asdict(st_out) == dataclasses.asdict(rst_out)
        assert st_in.index_match_ops > 0 and st_out.partial_nnz >= c_out.nnz

    def test_empty_outer(self):
        a = convert.to_csc(np.zeros((5, 4), np.float32))
        b = convert.to_csr(np.zeros((4, 6), np.float32))
        c, st_ = gustavson.spgemm_outer(a, b)
        assert c.nnz == 0 and c.shape == (5, 6) and st_.flops == 0


class TestSimulator:
    @pytest.mark.parametrize("num_pe,sw", [(1, 1), (2, 4), (8, 16), (32, 16)])
    def test_simulator_equals_reference(self, num_pe, sw):
        (a, b), (ra, rb) = _pair(11)
        c, stats = gustavson.FSpGEMMSimulator(num_pe, sw).run(convert.to_csv(a, num_pe), b)
        rc, rstats = r_gustavson.FSpGEMMSimulator(num_pe, sw).run(
            r_convert.to_csv(ra, num_pe), rb)
        _same_csr(c, rc)
        assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
        assert stats.b_row_fetches == convert.to_csv(a, num_pe).num_vectors()
        assert stats.flops == gustavson.gustavson_flops(a, b)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 500), num_pe=st.integers(1, 8), sw=st.integers(1, 16))
    def test_simulator_property(self, seed, num_pe, sw):
        """``tests/test_gustavson.py``'s property, held bitwise against the
        reference's simulator on the same inputs."""
        a, ra = _both(random_coo(17, 13, 0.2, "uniform", seed=seed))
        b, rb = _both(random_coo(13, 11, 0.25, "uniform", seed=seed + 1))
        a, b = convert.to_csr(a), convert.to_csr(b)
        ra, rb = r_convert.to_csr(ra), r_convert.to_csr(rb)
        c, stats = gustavson.FSpGEMMSimulator(num_pe, sw).run(convert.to_csv(a, num_pe), b)
        rc, rstats = r_gustavson.FSpGEMMSimulator(num_pe, sw).run(
            r_convert.to_csv(ra, num_pe), rb)
        _same_csr(c, rc)
        assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
        np.testing.assert_allclose(
            c.todense(), a.todense().astype(np.float64) @ b.todense().astype(np.float64),
            rtol=2e-4, atol=2e-4)
        assert stats.b_row_fetches <= max(a.nnz, 1)

    def test_simulator_rejects(self):
        with pytest.raises(ValueError):
            gustavson.FSpGEMMSimulator(0, 4)
        (a, b), _ = _pair(3)
        with pytest.raises(ValueError, match="NUM_PE"):
            gustavson.FSpGEMMSimulator(4, 4).run(convert.to_csv(a, 2), b)


def test_paper_matrices_config():
    assert paper_matrices.PAPER_MATRICES == r_paper_matrices.PAPER_MATRICES
    assert list(paper_matrices.SUITE) == list(r_paper_matrices.SUITE)
    for name in ("poisson3Da", "scircuit"):
        a = paper_matrices.suite_matrix(name, scale=0.01)
        ra = r_paper_matrices.suite_matrix(name, scale=0.01)
        _same_csr(a, ra)
