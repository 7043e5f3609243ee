"""Port parity: the host sparse layer of ``repro_torch`` against ``repro``.

Formats, conversions and the synthetic paper matrices are numpy code
carried over into the port; every array must equal the reference's
bitwise. Inputs are made with numpy from a seed and handed to both.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.sparse import convert as r_convert  # noqa: E402
from repro.sparse import formats as r_formats  # noqa: E402
from repro.sparse import random as r_random  # noqa: E402
from repro_torch.sparse import convert as t_convert  # noqa: E402
from repro_torch.sparse import formats as t_formats  # noqa: E402
from repro_torch.sparse import random as t_random  # noqa: E402


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_same(port, ref):
    """Same container type name and bitwise-equal fields (arrays compared
    with dtype and shape)."""
    assert type(port).__name__ == type(ref).__name__
    pf, rf = _fields(port), _fields(ref)
    assert pf.keys() == rf.keys()
    for name in pf:
        p, r = pf[name], rf[name]
        if isinstance(r, np.ndarray):
            assert p.dtype == r.dtype and p.shape == r.shape, name
            assert np.array_equal(p, r), name
        else:
            assert p == r, name


def _coo_pair(rows, cols, density, structure, seed):
    return (
        t_random.random_coo(rows, cols, density, structure, seed=seed),
        r_random.random_coo(rows, cols, density, structure, seed=seed),
    )


def test_suite_specs_match():
    assert t_random.SUITE.keys() == r_random.SUITE.keys()
    for name, spec in t_random.SUITE.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(r_random.SUITE[name])
        assert spec.nnz == r_random.SUITE[name].nnz


# Every paper matrix at scale 0.005, and all but the 1M-row webbase also at
# 0.02 (20k rows there add run time, not coverage).
_SUITE_CASES = [(n, 0.005) for n in sorted(r_random.SUITE)] + [
    (n, 0.02) for n in sorted(r_random.SUITE) if n != "webbase-1M"
]


@pytest.mark.parametrize("name,scale", _SUITE_CASES)
def test_suite_matrix_bitwise(name, scale):
    assert_same(t_random.suite_matrix(name, scale=scale, seed=3),
                r_random.suite_matrix(name, scale=scale, seed=3))


@pytest.mark.parametrize("structure", ["uniform", "fem", "graph", "circuit"])
def test_random_coo_bitwise(structure):
    t, r = _coo_pair(300, 250, 0.02, structure, seed=7)
    assert_same(t, r)


@pytest.mark.parametrize("shape,block,density", [
    ((128, 192), (32, 64), 0.3),
    ((256, 256), (64, 64), 0.15),
])
def test_random_block_sparse_bitwise(shape, block, density):
    t = t_random.random_block_sparse(*shape, block, density, seed=5)
    r = r_random.random_block_sparse(*shape, block, density, seed=5)
    assert t.dtype == r.dtype and np.array_equal(t, r)


@pytest.mark.parametrize("block,group", [((16, 16), 1), ((32, 16), 2), ((64, 64), 4)])
def test_block_conversions_with_scatter(block, group):
    t_coo, r_coo = _coo_pair(250, 230, 0.03, "fem", seed=11)
    tb, ts = t_convert.bcsv_from_coo(t_coo, block, group)
    rb, rs = r_convert.bcsv_from_coo(r_coo, block, group)
    assert_same(tb, rb)
    assert ts.dtype == rs.dtype and np.array_equal(ts, rs)
    tb.validate()
    bk = (block[1], block[0])
    tr, tsr = t_convert.bcsr_from_coo(t_coo, bk)
    rr, rsr = r_convert.bcsr_from_coo(r_coo, bk)
    assert_same(tr, rr)
    assert np.array_equal(tsr, rsr)
    assert_same(t_convert.to_bcsv(t_coo, block, group),
                r_convert.to_bcsv(r_coo, block, group))
    assert_same(t_convert.to_bcsr(t_coo, bk), r_convert.to_bcsr(r_coo, bk))


def test_dense_block_formats_and_round_trips():
    dense = r_random.random_block_sparse(128, 192, (32, 32), 0.3, seed=9)
    assert_same(t_formats.BCSR.fromdense(dense, (32, 32)),
                r_formats.BCSR.fromdense(dense, (32, 32)))
    t_bcsv = t_formats.BCSV.fromdense(dense, (32, 32), 2)
    assert_same(t_bcsv, r_formats.BCSV.fromdense(dense, (32, 32), 2))
    assert np.array_equal(t_bcsv.todense(), dense)
    assert_same(t_convert.to_coo(t_bcsv), r_convert.to_coo(
        r_formats.BCSV.fromdense(dense, (32, 32), 2)))


def test_element_formats_bitwise():
    t_coo, r_coo = _coo_pair(120, 90, 0.05, "uniform", seed=13)
    assert_same(t_convert.to_csr(t_coo), r_convert.to_csr(r_coo))
    assert_same(t_convert.to_csc(t_coo), r_convert.to_csc(r_coo))
    t_csv = t_convert.to_csv(t_coo, 4)
    assert_same(t_csv, r_convert.to_csv(r_coo, 4))
    t_csv.validate()
    assert t_csv.num_vectors() == r_convert.to_csv(r_coo, 4).num_vectors()
    assert_same(t_convert.csv_to_csr(t_csv),
                r_convert.csv_to_csr(r_convert.to_csv(r_coo, 4)))
    dense = t_coo.todense()
    assert np.array_equal(dense, r_coo.todense())
    assert_same(t_formats.CSR.fromdense(dense), r_formats.CSR.fromdense(dense))
    assert_same(t_convert.to_coo(dense), r_convert.to_coo(dense))
