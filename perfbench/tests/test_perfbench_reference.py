"""The plain reference, its control and the comparison that decides
``correct``, against dense products on small matrices."""
import numpy as np
import pytest
import torch

from perfbench import gen, reference


def _dense(p):
    d = np.zeros(p.shape)
    d[p.row, p.col] = p.val
    return d


@pytest.mark.parametrize("structure", ["fem", "graph", "circuit", "uniform"])
def test_exact_product_matches_dense(structure):
    a = gen.random_pattern(300, 200, 0.02, structure, 3)
    b = gen.random_pattern(200, 250, 0.03, "fem", 4)
    ex = reference.ExactProduct(a, b, "cpu")
    c, s = ex.values(a.val, b.val)
    want = _dense(a) @ _dense(b)
    struct = (_dense(a) != 0).astype(float) @ (_dense(b) != 0).astype(float)
    rows, cols = np.nonzero(struct)
    keys = rows * 250 + cols
    assert np.array_equal(ex.keys.numpy(), keys)
    np.testing.assert_allclose(c.numpy(), want[rows, cols], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s.numpy(), (np.abs(_dense(a)) @ np.abs(_dense(b)))[rows, cols],
                               rtol=1e-12)
    assert ex.pairs * 2 == int(2 * struct.sum())


def _csr(ex, data):
    return ex.csr(np.asarray(data, np.float32))


def _setup():
    a = gen.random_pattern(120, 120, 0.05, "fem", 1)
    ex = reference.ExactProduct(a, a, "cpu")
    c, s = ex.values(a.val, a.val)
    return a, ex, c, s


def test_compare_accepts_the_reference_and_block_fill():
    a, ex, c, s = _setup()
    r = reference.compare(ex, c, s, *_csr(ex, c.numpy()))
    assert r["c_missing"] == r["c_extra"] == r["c_structure"] == 0
    assert r["c_err"] < 1e-7
    # A block output stores zeros off the exact pattern; rows out of order.
    indptr, indices, data = _csr(ex, c.numpy())
    m, n = ex.shape
    full = np.zeros((m, n), np.float32)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    full[rows, indices] = data
    mask = np.zeros((m, n), bool)
    mask[rows, indices] = True
    mask[:, :8] = True  # zero fill
    order_rows, order_cols = np.nonzero(mask)
    perm = np.concatenate([np.random.default_rng(0).permutation(np.flatnonzero(order_rows == i))
                           for i in range(m)])
    dense_indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
    r = reference.compare(ex, c, s, dense_indptr, order_cols[perm],
                          full[order_rows[perm], order_cols[perm]])
    assert r == {"c_err": r["c_err"], "c_missing": 0, "c_extra": 0, "c_structure": 0}
    assert r["c_err"] < 1e-7


def test_compare_catches_each_fault():
    a, ex, c, s = _setup()
    indptr, indices, data = _csr(ex, c.numpy())
    bad = data.copy()
    bad[5] *= 1.001
    assert reference.compare(ex, c, s, indptr, indices, bad)["c_err"] > 1e-4
    nan = data.copy()
    nan[3] = np.nan
    assert reference.compare(ex, c, s, indptr, indices, nan)["c_err"] == reference.NONFINITE
    # An entry left out.
    drop = np.ones(data.shape[0], bool)
    drop[7] = False
    short = np.concatenate([[0], np.cumsum([drop[lo:hi].sum() for lo, hi in
                                            zip(indptr[:-1], indptr[1:])])])
    assert reference.compare(ex, c, s, short, indices[drop], data[drop])["c_missing"] == 1
    # A nonzero off the pattern: row 0 gains a stored entry in a column it lacks.
    col = np.setdiff1d(np.arange(ex.shape[1]), indices[indptr[0]:indptr[1]])[0]
    ind2 = np.insert(indices, indptr[1], col)
    dat2 = np.insert(data, indptr[1], 1.0)
    ptr2 = indptr.copy()
    ptr2[1:] += 1
    assert reference.compare(ex, c, s, ptr2, ind2, dat2)["c_extra"] == 1
    # A duplicate coordinate and a malformed CSR.
    ind3 = np.insert(indices, indptr[1], indices[0])
    assert reference.compare(ex, c, s, ptr2, ind3, np.insert(data, indptr[1], 0.0))[
        "c_structure"] == 1
    assert reference.compare(ex, c, s, indptr[:-1], indices, data)["c_structure"] == 1


def test_tf32_rounds_to_ten_mantissa_bits_nearest_even():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 3 * 2.0 ** -11, one + 2.0 ** -10,
                      -(one + 3 * 2.0 ** -11), 1.5 + 2.0 ** -12], dtype=torch.float32)
    want = [one, one + 2 * 2.0 ** -10, one + 2.0 ** -10, -(one + 2 * 2.0 ** -10), 1.5]
    assert reference.tf32(x).tolist() == want
