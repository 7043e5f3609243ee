"""Port parity: the symbolic phase and the Gustavson oracle of
``repro_torch`` against ``repro``, plus the port-only ``panel_runs``.

Schedules, assembly maps and their flat-array codecs are integer outputs:
they must equal the reference's arrays bitwise.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import gustavson as r_gus  # noqa: E402
from repro.core import schedule as r_sched  # noqa: E402
from repro.sparse import convert as r_convert  # noqa: E402
from repro.sparse import random as r_random  # noqa: E402
from repro_torch.core import gustavson as t_gus  # noqa: E402
from repro_torch.core import schedule as t_sched  # noqa: E402
from repro_torch.sparse import convert as t_convert  # noqa: E402
from repro_torch.sparse import random as t_random  # noqa: E402


def _assert_fields_equal(port, ref):
    for f in dataclasses.fields(ref):
        p, r = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(r, np.ndarray):
            assert p.dtype == r.dtype and np.array_equal(p, r), f.name
        else:
            assert p == r, f.name


def _suite_case(name, scale, tile, group):
    """A·Aᵀ of a scaled paper matrix, converted by each package."""
    t_csr = t_random.suite_matrix(name, scale=scale, seed=1)
    r_csr = r_random.suite_matrix(name, scale=scale, seed=1)
    bm = bk = bn = tile
    t_coo, r_coo = t_csr.to_coo(), r_csr.to_coo()
    t_bt = t_convert.to_coo(t_csr)
    t_bt = type(t_bt)(t_bt.col, t_bt.row, t_bt.val, (t_csr.shape[1], t_csr.shape[0]))
    r_bt = type(r_coo)(r_coo.col, r_coo.row, r_coo.val, (r_csr.shape[1], r_csr.shape[0]))
    t_a = t_convert.to_bcsv(t_coo, (bm, bk), group)
    t_b = t_convert.to_bcsr(t_bt, (bk, bn))
    r_a = r_convert.to_bcsv(r_coo, (bm, bk), group)
    r_b = r_convert.to_bcsr(r_bt, (bk, bn))
    shape = (t_csr.shape[0], t_csr.shape[0])
    return (t_a, t_b), (r_a, r_b), shape


def _block_case(shape, blocks, group, seed):
    m, k, n = shape
    bm, bk, bn = blocks
    ad = r_random.random_block_sparse(m, k, (bm, bk), 0.35, seed=seed)
    bd = r_random.random_block_sparse(k, n, (bk, bn), 0.4, seed=seed + 1)
    return (
        (t_convert.to_bcsv(ad, (bm, bk), group), t_convert.to_bcsr(bd, (bk, bn))),
        (r_convert.to_bcsv(ad, (bm, bk), group), r_convert.to_bcsr(bd, (bk, bn))),
        (m, n),
    )


_CASES = [
    ("poisson3Da", 0.005, 16, 2),
    ("poisson3Da", 0.02, 64, 4),
    ("2cubes_sphere", 0.01, 32, 4),
    ("scircuit", 0.005, 32, 4),
    ("cage12", 0.005, 16, 4),
    ("block", (128, 128, 128), (32, 32, 32), 1),
    ("block", (256, 128, 192), (64, 64, 64), 2),
    ("block", (256, 384, 256), (64, 64, 128), 4),
]


def _case(name, a, b, group):
    if name == "block":
        return _block_case(a, b, group, seed=3)
    return _suite_case(name, a, b, group)


@pytest.fixture(params=_CASES, ids=[f"{c[0]}-{c[1]}-{c[3]}" for c in _CASES])
def schedules(request):
    (t_a, t_b), (r_a, r_b), shape = _case(*request.param)
    t_s = t_sched.build_spgemm_schedule(t_a, t_b)
    r_s = r_sched.build_spgemm_schedule(r_a, r_b)
    block = (t_a.block_shape[0], t_b.block_shape[1])
    return t_s, r_s, block, shape


def test_schedule_bitwise(schedules):
    t_s, r_s, _, _ = schedules
    _assert_fields_equal(t_s, r_s)
    assert t_s.b_fetches() == r_s.b_fetches()
    assert t_s.block_omar() == r_s.block_omar()


def test_assembly_map_bitwise(schedules):
    t_s, r_s, block, shape = schedules
    _assert_fields_equal(
        t_sched.build_assembly_map(t_s, block, shape),
        r_sched.build_assembly_map(r_s, block, shape),
    )


def test_codecs_match_and_cross_decode(schedules):
    t_s, r_s, block, shape = schedules
    t_arr = t_sched.schedule_to_arrays(t_s)
    r_arr = r_sched.schedule_to_arrays(r_s)
    assert t_arr.keys() == r_arr.keys()
    for k in r_arr:
        assert t_arr[k].dtype == r_arr[k].dtype and np.array_equal(t_arr[k], r_arr[k])
    _assert_fields_equal(t_sched.schedule_from_arrays(r_arr), r_s)
    r_asm = r_sched.build_assembly_map(r_s, block, shape)
    t_asm_arr = t_sched.assembly_to_arrays(t_sched.build_assembly_map(t_s, block, shape))
    r_asm_arr = r_sched.assembly_to_arrays(r_asm)
    assert t_asm_arr.keys() == r_asm_arr.keys()
    for k in r_asm_arr:
        assert np.array_equal(t_asm_arr[k], r_asm_arr[k])
    _assert_fields_equal(t_sched.assembly_from_arrays(r_asm_arr), r_asm)


def test_panel_runs_cover_every_triple_once(schedules):
    t_s, _, _, _ = schedules
    ptr, order = t_sched.panel_runs(t_s)
    g = t_s.group
    assert ptr.shape == (t_s.n_panels * g + 1,) and ptr[0] == 0
    assert ptr[-1] == t_s.num_triples and np.all(np.diff(ptr) >= 0)
    # Every triple in exactly one run.
    assert np.array_equal(np.sort(order), np.arange(t_s.num_triples))
    for tile in range(t_s.n_panels * g):
        run = order[ptr[tile]:ptr[tile + 1]]
        # The run's triples belong to this tile, in triple order.
        assert np.all(t_s.panel[run] == tile // g)
        assert np.all(t_s.sub_row[run] == tile % g)
        assert np.all(np.diff(run) > 0)


def test_panel_runs_empty_schedule():
    a = t_convert.to_bcsv(np.zeros((32, 32), np.float32), (16, 16), 2)
    b = t_convert.to_bcsr(np.zeros((32, 32), np.float32), (16, 16))
    s = t_sched.build_spgemm_schedule(a, b)
    ptr, order = t_sched.panel_runs(s)
    assert s.num_triples == 0 and ptr.tolist() == [0] and order.size == 0


@pytest.mark.parametrize("name,scale", [("poisson3Da", 0.01), ("cage12", 0.005),
                                        ("scircuit", 0.005)])
def test_gustavson_oracle_bitwise(name, scale):
    t_a = t_random.suite_matrix(name, scale=scale, seed=2)
    r_a = r_random.suite_matrix(name, scale=scale, seed=2)
    t_c = t_gus.spgemm_gustavson(t_a, t_a)
    r_c = r_gus.spgemm_gustavson(r_a, r_a)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(t_c, f), getattr(r_c, f)), f
    assert t_c.shape == r_c.shape
    assert t_gus.gustavson_flops(t_a, t_a) == r_gus.gustavson_flops(r_a, r_a)
