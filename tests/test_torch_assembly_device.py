"""The block assembly map built with tensor ops
(``core/schedule.py::assembly_map_on``, which a CUDA plan runs on the card),
run here on the CPU, against the host's ``build_assembly_map``: the
gather's values and dtype, ``indptr``, ``indices`` and ``shape`` bitwise,
over square and rectangular blocks, groups 1 and 4, outputs that overhang
in m only, in n only, in both and in neither, an empty C and a gather too
wide for int32. A schedule whose C blocks are not ascending is refused by
the tensor version and takes the host's sort."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as S
from repro_torch.sparse.convert import to_bcsr, to_bcsv
from repro_torch.sparse.random import random_coo

BLOCKS = [(8, 8), (64, 64), (8, 16), (16, 8)]  # C's (bm, bn)
OVERHANG = ["none", "m", "n", "both"]


def _schedule(bm, bn, group, overhang, seed=7, empty=False):
    """A·B with A ``[m, k]``, B ``[k, n]`` at about a third of their blocks
    filled; ``m`` and ``n`` fall a quarter block short of the grid where
    ``overhang`` says so."""
    bk = 8 if bm < 64 else 64
    m = 6 * bm - (bm // 4 if overhang in ("m", "both") else 0)
    n = 7 * bn - (bn // 4 if overhang in ("n", "both") else 0)
    k = 5 * bk
    a = random_coo(m, k, 0.4 / (bm * bk), seed=seed)
    b = random_coo(k, n, 0.4 / (bk * bn), seed=seed + 1)
    if empty:  # A's nonzeros only in columns where B has none
        b = type(b)(b.row[b.row >= bk], b.col[b.row >= bk], b.val[b.row >= bk], b.shape)
        keep = a.col < bk
        a = type(a)(a.row[keep], a.col[keep], a.val[keep], a.shape)
    sch = S.build_spgemm_schedule(to_bcsv(a, (bm, bk), group), to_bcsr(b, (bk, bn)))
    return sch, (m, n)


def _assert_same(got, want):
    assert got.shape == want.shape
    for f in ("gather", "indptr", "indices"):
        x, y = getattr(got, f), getattr(want, f)
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        x = x.numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f


CASES = [(blocks, group, overhang) for blocks in BLOCKS for group in (1, 4)
         for overhang in OVERHANG] + [((8, 8), 4, "empty"), ((8, 16), 4, "int64")]


@pytest.mark.parametrize("blocks,group,overhang", CASES)
def test_tensor_map_equals_host_map_bitwise(blocks, group, overhang, monkeypatch):
    bm, bn = blocks
    sch, out_shape = _schedule(bm, bn, group, "both" if overhang == "int64" else overhang,
                               empty=overhang == "empty")
    if overhang == "int64":
        # The dtype a gather into more than int32 panels takes, here forced
        # at a small size: both versions read it from _block_bases.
        bases = S._block_bases
        monkeypatch.setattr(S, "_block_bases", lambda *a: (bases(*a)[0], np.int64))
    want = S.build_assembly_map(sch, blocks, out_shape)
    got = S.assembly_map_on("cpu", sch, blocks, out_shape)
    _assert_same(got, want)
    if overhang == "empty":
        assert sch.nnzb_c == 0 and want.nnz == 0
        return
    assert want.nnz > 0
    assert want.gather.dtype == (np.int64 if overhang == "int64" else np.int32)
    # The case reaches what it names: C has blocks in the overhanging last
    # block row / block column.
    m, n = out_shape
    if overhang in ("m", "both"):
        assert m % bm and (sch.c_brow == (m - 1) // bm).any()
    if overhang in ("n", "both"):
        assert n % bn and (sch.c_bcol == (n - 1) // bn).any()


def test_a_schedule_not_in_block_order_takes_the_host_path():
    sch, out_shape = _schedule(8, 16, 4, "both")
    order = np.random.default_rng(0).permutation(sch.nnzb_c)
    shuffled = dataclasses.replace(sch, c_brow=sch.c_brow[order], c_bcol=sch.c_bcol[order])
    assert not S._blocks_ascending(shuffled.c_brow, shuffled.c_bcol, shuffled.grid_n)
    with pytest.raises(ValueError, match="ascending"):
        S.assembly_map_on("cpu", shuffled, (8, 16), out_shape)
    # The host's build sorts it into the same map.
    want = S.build_assembly_map(sch, (8, 16), out_shape)
    got = S.build_assembly_map(shuffled, (8, 16), out_shape)
    for f in ("gather", "indptr", "indices"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
