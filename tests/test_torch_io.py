"""Port parity: ``repro_torch.sparse.io`` against the JAX package's
``repro.sparse.io``. A file written by one package is read back by the
other bitwise: Matrix Market text (real, integer and pattern fields,
general and symmetric) and the ``.npz`` containers of the pre-processed
CSV and BCSV forms.
"""
import numpy as np
import pytest

from repro.sparse import io as r_io
from repro.sparse.convert import to_bcsv as r_to_bcsv, to_csv as r_to_csv
from repro.sparse.formats import COO as R_COO
from repro.sparse.random import random_coo as r_random_coo
from repro_torch.sparse import io
from repro_torch.sparse.convert import to_bcsv, to_csv
from repro_torch.sparse.formats import COO, CSR
from repro_torch.sparse.random import random_block_sparse

PACKAGES = {"port": io, "reference": r_io}


def _coo(seed=0):
    c = r_random_coo(40, 30, 0.1, "uniform", seed=seed).sum_duplicates()
    c.val = np.random.default_rng(seed).standard_normal(c.nnz).astype(np.float32)
    return COO(c.row, c.col, c.val, c.shape), R_COO(c.row, c.col, c.val, c.shape)


def _same_coo(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    for f in ("row", "col", "val"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_matrix_market_round_trip_across_packages(tmp_path, writer, reader):
    """``write_matrix_market`` then ``read_matrix_market``, COO and CSR
    inputs: the values survive (9 significant digits round-trip float32)."""
    t, r = _coo(1)
    path = str(tmp_path / "a.mtx")
    PACKAGES[writer].write_matrix_market(path, t if writer == "port" else r)
    got = PACKAGES[reader].read_matrix_market(path)
    _same_coo(got, t)
    csr_path = str(tmp_path / "b.mtx")
    if writer == "port":
        io.write_matrix_market(csr_path, CSR.from_coo(t))
        assert open(csr_path).read() == open(path).read()


@pytest.mark.parametrize("field,symmetry", [("real", "general"), ("integer", "symmetric"),
                                            ("pattern", "general"), ("real", "symmetric")])
def test_matrix_market_headers_read_alike(tmp_path, field, symmetry):
    """Files with each field and symmetry (comments, duplicates, a diagonal
    entry) read the same through both packages."""
    entries = [(1, 1, 2.5), (3, 1, -1.0), (2, 4, 4.0), (3, 1, 0.5), (4, 2, 7.0)]
    lines = [f"%%MatrixMarket matrix coordinate {field} {symmetry}", "% a comment",
             f"4 4 {len(entries)}"]
    for i, j, v in entries:
        val = "" if field == "pattern" else f" {int(v) if field == 'integer' else v}"
        lines.append(f"{i} {j}{val}")
    path = tmp_path / "h.mtx"
    path.write_text("\n".join(lines) + "\n")
    got, want = io.read_matrix_market(str(path)), r_io.read_matrix_market(str(path))
    _same_coo(got, want)
    if symmetry == "symmetric":
        dense = got.todense()
        assert np.array_equal(dense, dense.T)


def test_matrix_market_rejects_other_formats(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a header\n")
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        io.read_matrix_market(str(bad))
    bad.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError, match="coordinate"):
        io.read_matrix_market(str(bad))


@pytest.mark.parametrize("form", ["csv", "bcsv"])
@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_npz_containers_across_packages(tmp_path, form, writer, reader):
    """``save_csv``/``load_csv`` and ``save_bcsv``/``load_bcsv``: each
    package reads the other's file into the same arrays, with or without
    the ``.npz`` suffix."""
    if form == "csv":
        t, r = _coo(2)
        port, ref = to_csv(t, 4), r_to_csv(r, 4)
        fields = ("val", "row_ind", "col_ind")
    else:
        d = random_block_sparse(64, 96, (16, 32), 0.4, seed=3)
        port, ref = to_bcsv(d, (16, 32), 2), r_to_bcsv(d, (16, 32), 2)
        fields = ("blocks", "brow", "bcol", "group_ptr")
    path = str(tmp_path / f"m_{form}")
    getattr(PACKAGES[writer], f"save_{form}")(path, port if writer == "port" else ref)
    got = getattr(PACKAGES[reader], f"load_{form}")(path + ".npz")
    want = ref if reader == "port" else port
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert tuple(got.shape) == tuple(want.shape)
    assert (got.num_pe if form == "csv" else got.group) == (4 if form == "csv" else 2)
