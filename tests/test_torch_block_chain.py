"""Block plans at small tiles on the CPU, the plain PyTorch path: the
group-1 block schedule built in vectorized steps against the loop it
replaces and the JAX package's builder (bitwise, on random patterns at
tiles 1 to 16 and on 3-D elasticity's patterns), and a chain of tile-3
block plans, the Galerkin product ``R·A·P`` of smoothed aggregation for
3-D linear elasticity (3 x 3 node blocks in A, 3 x 6 in P, ``R = Pᵀ``),
against the float64 plain chain of ``repro_torch.spgemm.plain``, exactly
on small integers, and bitwise against its stages with a host round trip."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as sched
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo
from repro_torch.sparse.formats import BCSV, COO
from repro_torch.sparse.random import random_coo
from repro_torch.spgemm import PlanCache, execute_chain, spgemm_plan
from repro_torch.spgemm.plain import chain_product

TILES = [(1, 1, 1), (2, 2, 2), (3, 3, 3), (4, 4, 4), (16, 16, 16), (3, 3, 6)]


def _canonical(rows, cols, shape, vals=None):
    order = np.lexsort((cols, rows))
    rows, cols = np.asarray(rows)[order], np.asarray(cols)[order]
    vals = np.ones(rows.shape[0], np.float32) if vals is None else np.asarray(vals)[order]
    return COO(rows.astype(np.int64), cols.astype(np.int64), vals, shape)


def _kron(m: COO, br: int, bc: int) -> COO:
    """``m``'s pattern with every entry a dense ``br`` x ``bc`` block."""
    rows = (br * m.row)[:, None, None] + np.arange(br)[None, :, None]
    cols = (bc * m.col)[:, None, None] + np.arange(bc)[None, None, :]
    shape3 = (m.nnz, br, bc)
    return _canonical(np.broadcast_to(rows, shape3).ravel(), np.broadcast_to(cols, shape3).ravel(),
                      (br * m.shape[0], bc * m.shape[1]))


def _elasticity(n, seed, integer=False):
    """``(R, A, P)`` of smoothed aggregation for 3-D elasticity at ``n``³
    nodes: the 27-point nodal stencil with 3 x 3 blocks; greedy
    aggregation in row order (pass 1 takes each node whose neighbourhood
    is free, pass 2 gives every other node its first aggregated
    neighbour's aggregate); P with the nodal pattern of A·P₀ and 3 x 6
    blocks (the 6 rigid-body modes); R = Pᵀ with P's values. Values are
    standard normal, or with ``integer`` nonzero integers in [-3, 3]."""
    z, y, x = np.unravel_index(np.arange(n ** 3), (n, n, n))
    d = np.array([-1, 0, 1])
    dz, dy, dx = (g.ravel() for g in np.meshgrid(d, d, d, indexing="ij"))
    zz, yy, xx = z[:, None] + dz, y[:, None] + dy, x[:, None] + dx
    inside = (zz >= 0) & (zz < n) & (yy >= 0) & (yy < n) & (xx >= 0) & (xx < n)
    nb = np.where(inside, (zz * n + yy) * n + xx, -1)
    agg = np.full(n ** 3, -1)
    count = 0
    for i in range(n ** 3):
        if (agg[nb[i][nb[i] >= 0]] < 0).all():
            agg[nb[i][nb[i] >= 0]] = count
            count += 1
    first = agg.copy()
    for i in np.flatnonzero(first < 0):
        near = first[nb[i][nb[i] >= 0]]
        agg[i] = near[near >= 0][0]
    rows = np.broadcast_to(np.arange(n ** 3)[:, None], nb.shape)[inside]
    a_node = _canonical(rows, nb[inside], (n ** 3, n ** 3))
    keys = np.unique(a_node.row * count + agg[a_node.col])
    p_node = _canonical(keys // count, keys % count, (n ** 3, count))
    a, p = _kron(a_node, 3, 3), _kron(p_node, 3, 6)
    rng = np.random.default_rng(seed)

    def draw(k):
        if integer:
            return rng.choice(np.array([-3, -2, -1, 1, 2, 3], np.float32), k)
        return rng.standard_normal(k).astype(np.float32)

    a = COO(a.row, a.col, draw(a.nnz), a.shape)
    p = COO(p.row, p.col, draw(p.nnz), p.shape)
    r = _canonical(p.col, p.row, (p.shape[1], p.shape[0]), p.val)
    return r, a, p


def _blocks(a: COO, b: COO, tile):
    bm, bk, bn = tile
    return (bcsv_from_coo(a, (bm, bk), 1)[0], bcsr_from_coo(b, (bk, bn))[0])


def _loop(monkeypatch, a, b):
    with monkeypatch.context() as m:
        m.setattr(sched, "_group1_schedule", lambda a, b: None)
        return sched.build_spgemm_schedule(a, b)


def _assert_same(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name


def _random_case(tile, seed):
    a = random_coo(70, 60, 0.05, seed=seed).sum_duplicates()
    b = random_coo(60, 80, 0.06, "fem", seed=seed + 10).sum_duplicates()
    return _blocks(a, b, tile)


def _elasticity_cases(n):
    """The two stages' block operands at tile 3: R·A, then R·A's pattern
    times P."""
    r, a, p = _elasticity(n, 0)
    ra = spgemm_plan(r, a, tile=3, group=1, device="cpu", cache=PlanCache()).output_pattern()
    return [_blocks(r, a, (3, 3, 3)), _blocks(ra.to_coo(), p, (3, 3, 3))]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group1_schedule_equals_the_loop_bitwise(monkeypatch, tile, seed):
    a, b = _random_case(tile, seed)
    schedule = sched.build_spgemm_schedule(a, b)
    assert schedule.num_triples > 0 and schedule.group == 1
    _assert_same(schedule, _loop(monkeypatch, a, b))


@pytest.mark.parametrize("n", [6, 7, 9])
def test_group1_schedule_of_elasticity_equals_the_loop_bitwise(monkeypatch, n):
    for a, b in _elasticity_cases(n):
        _assert_same(sched.build_spgemm_schedule(a, b), _loop(monkeypatch, a, b))


def _jax_schedule(a: BCSV, b):
    from repro.core import schedule as r_sched
    from repro.sparse.formats import BCSR as R_BCSR
    from repro.sparse.formats import BCSV as R_BCSV

    ra = R_BCSV(a.blocks, a.brow, a.bcol, a.group_ptr, a.shape, a.group)
    rb = R_BCSR(b.indptr, b.indices, b.blocks, b.shape)
    return r_sched.build_spgemm_schedule(ra, rb)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "x".join(map(str, t)))
def test_group1_schedule_equals_the_jax_builder(tile):
    pytest.importorskip("jax")
    for seed in (3, 4):
        a, b = _random_case(tile, seed)
        _assert_same(sched.build_spgemm_schedule(a, b), _jax_schedule(a, b))


@pytest.mark.parametrize("n", [6, 8])
def test_group1_schedule_of_elasticity_equals_the_jax_builder(n):
    pytest.importorskip("jax")
    for a, b in _elasticity_cases(n):
        _assert_same(sched.build_spgemm_schedule(a, b), _jax_schedule(a, b))


def test_blocks_out_of_order_and_other_groups_take_the_loop(monkeypatch):
    """A BCSV whose blocks do not ascend in (brow, bcol) is built by the
    loop, on its own terms; group 2 never reaches the vectorized path."""
    a, b = _random_case((3, 3, 3), 5)
    rev = BCSV(a.blocks[::-1], a.brow[::-1], a.bcol[::-1], a.group_ptr, a.shape, 1)
    assert sched._group1_schedule(rev, b) is None
    _assert_same(sched.build_spgemm_schedule(rev, b), _loop(monkeypatch, rev, b))
    called = []
    monkeypatch.setattr(sched, "_group1_schedule", lambda *x: called.append(x))
    a2 = bcsv_from_coo(random_coo(70, 60, 0.05, seed=5).sum_duplicates(), (3, 3), 2)[0]
    assert sched.build_spgemm_schedule(a2, b).group == 2 and not called


def _chain(r, a, p):
    return spgemm_plan(r, a, tile=3, group=1, device="cpu", cache=PlanCache()).then(
        p, cache=PlanCache())


def _abs(c: COO) -> COO:
    return COO(c.row, c.col, np.abs(c.val), c.shape)


def _rows(c):
    return np.repeat(np.arange(c.shape[0]), np.diff(c.indptr))


def test_a_tile_3_elasticity_chain_matches_the_plain_chain():
    """``spgemm_plan(R, A, tile=3, group=1).then(P)``: dense blocks, so the
    block output is A_c's exact pattern, and each entry is within 1e-5 of
    the plain chain relative to Σ|r|·|a|·|p|; fresh A values too."""
    r, a, p = _elasticity(6, 1)
    chain = _chain(r, a, p)
    assert [q.report.tile for q in chain.plans] == [(3, 3, 3)] * 2
    c = chain.execute()
    want = chain_product([r, a, p], intermediate=torch.float32)
    scale = chain_product([_abs(r), _abs(a), _abs(p)])
    assert np.array_equal(_rows(c), want.row) and np.array_equal(c.indices, want.col)
    assert np.all(np.abs(c.data - want.val) <= 1e-5 * scale.val)
    a2 = np.random.default_rng(9).standard_normal(a.nnz).astype(np.float32)
    c2 = execute_chain(chain, b_vals=a2)
    want2 = chain_product([r, COO(a.row, a.col, a2, a.shape), p])
    assert np.all(np.abs(c2.data - want2.val) <= 1e-5 * scale.val)
    assert not np.array_equal(c2.data, c.data)


def test_a_tile_3_chain_on_small_integers_is_exact():
    r, a, p = _elasticity(5, 2, integer=True)
    c = _chain(r, a, p).execute()
    want = chain_product([r, a, p])
    assert np.array_equal(_rows(c), want.row) and np.array_equal(c.indices, want.col)
    assert np.array_equal(c.data.astype(np.float64), want.val)


@pytest.mark.parametrize("integer", [False, True])
def test_a_tile_3_chain_equals_its_stages_with_a_host_round_trip(integer):
    r, a, p = _elasticity(6, 3, integer=integer)
    chain = _chain(r, a, p)
    got = execute_chain(chain)
    ra = spgemm_plan(r, a, tile=3, group=1, device="cpu", cache=PlanCache()).execute()
    want = spgemm_plan(COO(_rows(ra), ra.indices, ra.data, ra.shape), p, tile=3, group=1,
                       device="cpu", cache=PlanCache()).execute()
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)
