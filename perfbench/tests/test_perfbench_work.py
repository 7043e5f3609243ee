"""The work counts against hand counts, and the least time."""
import numpy as np

from perfbench import gen, reference, work


def _pattern(rows, cols, shape):
    r, c = np.array(rows, np.int32), np.array(cols, np.int32)
    return gen.Pattern(r, c, np.ones(r.shape[0], np.float32), shape)


def test_counts_by_hand():
    # A = [[1 1 0], [0 1 0]], B = [[1 0], [1 1], [0 1]]:
    # column 0 of A (1 entry) meets row 0 of B (1), column 1 (2) meets
    # row 1 (2): 1*1 + 2*2 = 5 products; C = [[x x], [x x]] exactly.
    a = _pattern([0, 0, 1], [0, 1, 1], (2, 3))
    b = _pattern([0, 1, 1, 2], [0, 0, 1, 1], (3, 2))
    assert work.product_flops(a, b) == 10
    ex = reference.ExactProduct(a, b, "cpu")
    assert ex.nnz == 4 and ex.pairs == 5
    assert work.product_bytes(a.nnz, b.nnz, ex.nnz) == (3 + 4 + 4) * 8


def test_least_seconds_is_the_larger_bound():
    peaks = work.PEAKS["H100"]
    assert work.least_seconds(67e12, 0, peaks) == 1.0
    assert work.least_seconds(0, 3.35e12, peaks) == 1.0
    assert work.least_seconds(67e12, 2 * 3.35e12, peaks) == 2.0
    assert work.peak("NVIDIA H100 80GB HBM3") is peaks
    assert work.peak("cpu") is None


def test_fem14k_sizes_are_the_configurations():
    # The stand-in holds exactly the density's nonzeros, and the sizes its
    # configuration states.
    import json

    from conftest import ROOT

    cfg = json.loads((ROOT / "perfbench/configs/fem14k.json").read_text())
    a = gen.matrix(cfg["matrices"]["A"])
    assert a.nnz == cfg["sizes"]["A_nnz"] == 372_400
    assert gen.matrix(cfg["matrices"]["B2"]).nnz == cfg["sizes"]["B2_nnz"]
    ex = reference.ExactProduct(a, a, "cpu")
    assert ex.pairs == cfg["sizes"]["AA_pairs"]
    assert ex.nnz == cfg["sizes"]["AA_exact_c_nnz"]
    assert work.product_flops(a, a) == 2 * ex.pairs


def test_trim_keeps_a_canonical_pattern():
    p = gen.random_pattern(3000, 3000, 2e-3, "fem", 4)
    assert p.nnz == 18_000
    keys = p.row.astype(np.int64) * 3000 + p.col
    assert np.all(np.diff(keys) > 0)
