"""Chains of ``output="exact"`` plans (tile 1, group 1) on the CPU, the
plain PyTorch path: an algebraic multigrid's Galerkin product
``A_c = R·A·P`` (smoothed aggregation on the 27-point stencil, ``R = Pᵀ``)
against the plain chain of ``repro_torch.spgemm.plain``; a chain bitwise
equal to its stages run one at a time with a host round trip; later stages
bound positionally, with no gather; the cache keys of chained exact plans;
the refusals (a chain that mixes exact and other stages, and what exact
plans do not serve); and the plain chain itself against dense products."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.runtime import heartbeat as hb
from repro_torch.sparse.formats import COO
from repro_torch.sparse.random import random_coo
from repro_torch.spgemm import (
    PlanCache,
    SpGEMMChain,
    execute_chain,
    plan_from_structural_pattern,
    schedule_build_count,
    spgemm_plan,
)
from repro_torch.spgemm import executor as executor_mod
from repro_torch.spgemm.plain import chain_product, product


@pytest.fixture(autouse=True)
def fresh_recorder():
    hb.set_tracing(False)
    hb.default_recorder().clear()
    yield
    hb.set_tracing(False)
    hb.default_recorder().clear()


def _exact(a, b, **kw):
    kw.setdefault("cache", PlanCache())
    return spgemm_plan(a, b, tile=1, group=1, output="exact", device="cpu", **kw)


def _values(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _stencil(n):
    """The 27-point stencil's pattern on an ``n``³ grid, canonical COO
    (x fastest), with unit values."""
    z, y, x = np.unravel_index(np.arange(n ** 3), (n, n, n))
    rows, cols = [], []
    for i in range(n ** 3):
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            p = (z[i] + dz, y[i] + dy, x[i] + dx)
            if all(0 <= c < n for c in p):
                rows.append(i)
                cols.append(np.ravel_multi_index(p, (n, n, n)))
    return COO(np.array(rows), np.array(cols), np.ones(len(rows), np.float32),
               (n ** 3, n ** 3))


def _galerkin(n, seed):
    """``(R, A, P)`` of smoothed aggregation on the 27-point stencil at
    ``n``³: greedy aggregation in row order (pass 1 takes each node whose
    neighbourhood is free, pass 2 puts every other node in the aggregate
    of its first aggregated neighbour), P with the pattern of A·P₀ and
    random values, R = Pᵀ with P's values, A with random values."""
    a = _stencil(n)
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
    keys = np.unique(a.row.astype(np.int64) * count + agg[a.col])
    p_row, p_col = keys // count, keys % count
    p_val = _values(keys.shape[0], seed)
    order = np.lexsort((p_row, p_col))
    r = COO(p_col[order], p_row[order], p_val[order], (count, n ** 3))
    a = COO(a.row, a.col, _values(a.nnz, seed + 1), a.shape)
    return r, a, COO(p_row, p_col, p_val, (n ** 3, count))


def _abs(c: COO) -> COO:
    return COO(c.row, c.col, np.abs(c.val), c.shape)


def _rows(c):
    return np.repeat(np.arange(c.shape[0]), np.diff(c.indptr))


def test_the_galerkin_product_at_12_cubed_matches_the_plain_chain():
    """``spgemm_plan(R, A, output="exact").then(P)``: A_c's pattern is the
    plain chain's, and each entry is within 1e-5 of it, relative to the
    sum of its products' magnitudes Σ|r|·|a|·|p|."""
    r, a, p = _galerkin(12, 1)
    assert r.shape == (64, 1728) and a.nnz == 34 ** 3 and p.shape == (1728, 64)
    chain = _exact(r, a).then(p)
    assert [q.output for q in chain.plans] == ["exact", "exact"]
    c = chain.execute()
    want = chain_product([r, a, p], intermediate=torch.float32)
    scale = chain_product([_abs(r), _abs(a), _abs(p)])
    assert np.array_equal(_rows(c), want.row) and np.array_equal(c.indices, want.col)
    assert np.array_equal(scale.row, want.row) and np.array_equal(scale.col, want.col)
    assert np.all(np.abs(c.data - want.val) <= 1e-5 * scale.val)
    # Fresh values for A, as a solver's next step brings: R and P stay.
    a2 = _values(a.nnz, 7)
    c2 = execute_chain(chain, b_vals=a2)
    want2 = chain_product([r, COO(a.row, a.col, a2, a.shape), p], intermediate=torch.float32)
    assert np.all(np.abs(c2.data - want2.val) <= 1e-5 * scale.val)
    assert not np.array_equal(c2.data, c.data)


@pytest.mark.parametrize("stages", [2, 3])
def test_an_exact_chain_equals_its_stages_with_a_host_round_trip(stages):
    """Each stage run on its own, its CSR result taken to the host and
    planned again as the next stage's A: the chain's C, bitwise."""
    ops = [random_coo(90, 80, 0.05, "graph", seed=40), random_coo(80, 100, 0.05, seed=41),
           random_coo(100, 70, 0.05, "fem", seed=42),
           random_coo(70, 60, 0.05, "circuit", seed=39)][:stages + 1]
    chain = _exact(ops[0], ops[1])
    for b in ops[2:]:
        chain = chain.then(b)
    got = execute_chain(chain)
    c = _exact(ops[0], ops[1]).execute()
    for b in ops[2:]:
        c = _exact(COO(_rows(c), c.indices, c.data, c.shape), b).execute()
    assert np.array_equal(got.indptr, c.indptr) and np.array_equal(got.indices, c.indices)
    assert np.array_equal(got.data, c.data)


def test_later_stages_bind_positionally_and_launch_no_gather(monkeypatch):
    """At tile 1 the identity binds and the identity assembly run for every
    stage: no scatter inverse and no gather map is staged, and the stage
    cores are handed none."""
    r, a, p = _galerkin(5, 2)
    chain = _exact(r, a).then(p)
    stage2 = chain.plans[1]
    assert stage2.a_pattern.nnz == chain.plans[0].output_pattern().nnz
    for q in chain.plans:
        ex = q._executor
        assert ex._a_inv is None and ex._b_inv is None and ex._gather is None
    seen = []
    real_bind, real_assemble = executor_mod.bind_core, executor_mod.assemble_core
    monkeypatch.setattr(executor_mod, "bind_core",
                        lambda vals, inv, *, shape: seen.append(inv) or real_bind(
                            vals, inv, shape=shape))
    monkeypatch.setattr(executor_mod, "assemble_core",
                        lambda panels, gather: seen.append(gather) or real_assemble(
                            panels, gather))
    chain.execute()
    assert len(seen) == 6 and all(x is None for x in seen)


@pytest.mark.parametrize("how", ["then_compact", "chain_of_both", "compact_then_exact"])
def test_a_chain_that_mixes_exact_and_other_stages_is_refused(how):
    a = random_coo(60, 60, 0.06, seed=43)
    exact = _exact(a, a)
    compact = spgemm_plan(a, a, tile=1, group=1, output="compact", device="cpu",
                          cache=PlanCache())
    calls = {
        "then_compact": lambda: exact.then(a, output="compact"),
        "chain_of_both": lambda: SpGEMMChain([compact, plan_from_structural_pattern(
            compact.output_pattern(), a, tile=1, group=1, output="exact", device="cpu",
            cache=PlanCache())]),
        "compact_then_exact": lambda: compact.then(a, output="exact"),
    }
    with pytest.raises(ValueError, match="either all output='exact' plans or has no exact"):
        calls[how]()


@pytest.mark.parametrize("entry", ["tile", "mesh", "persist"])
def test_chained_exact_plans_refuse_what_exact_plans_refuse(entry):
    from repro_torch.launch.mesh import make_shard_mesh

    a = random_coo(50, 50, 0.08, seed=44)
    plan = _exact(a, a)
    pattern = plan.output_pattern()
    calls = {
        "tile": (lambda: plan_from_structural_pattern(
            pattern, a, tile=2, group=1, output="exact", device="cpu"), "takes tile=1"),
        "mesh": (lambda: plan_from_structural_pattern(
            pattern, a, tile=1, group=1, output="exact", device="cpu",
            mesh=make_shard_mesh(2, devices=["cpu"] * 2)), "do not serve sharded"),
        "persist": (lambda: plan.then(a).plans[1].persist_artifacts(),
                    "do not serve persistence"),
    }
    call, match = calls[entry]
    with pytest.raises(ValueError, match=match):
        call()


def test_chained_exact_plans_are_cached_apart_and_hit_without_a_rebuild(tmp_path):
    """A chained exact stage is cached under a key of its own (tagged for
    chains and for exact output): a second ``then`` hits it, the compact
    stage of the same pattern at tile 1 is another plan, and the disk tier
    stores nothing for it."""
    a, b = random_coo(70, 70, 0.06, seed=45), random_coo(70, 60, 0.06, seed=46)
    cache = PlanCache(disk_dir=str(tmp_path))
    first = spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu", cache=cache)
    stage = first.then(b, cache=cache).plans[1]
    assert stage.output == "exact" and cache.stats.stores == 0
    builds = schedule_build_count()
    assert first.then(b, cache=cache).plans[1] is stage
    assert schedule_build_count() == builds
    compact = plan_from_structural_pattern(first.output_pattern(), b, tile=1, group=1,
                                           output="compact", device="cpu", cache=cache)
    assert compact is not stage and compact.output == "compact"
    keys = [k for k in cache._plans if k[0] == stage.report.pattern_key]
    assert sorted(k[-1] for k in keys) == ["compact", "exact"]


def test_the_plain_chain_is_the_dense_product():
    """``plain.product`` of unordered operands with duplicate coordinates
    is the dense product on the structural pattern, entries that sum to
    zero kept; ``chain_product`` rounds intermediates only when asked."""
    rng = np.random.default_rng(47)
    a = COO(np.array([2, 0, 0, 1, 2]), np.array([1, 0, 0, 1, 2]),
            np.array([1.0, 2.0, 0.5, 3.0, -1.0], np.float32), (3, 3))
    b = COO(np.array([1, 0, 2, 1]), np.array([0, 1, 0, 2]),
            np.array([4.0, 1.0, 4.0, 0.25], np.float32), (3, 3))
    c = product(a, b)
    dense = np.zeros((3, 3))
    np.add.at(dense, (a.row, a.col), a.val)
    dense_b = np.zeros((3, 3))
    np.add.at(dense_b, (b.row, b.col), b.val)
    want = dense @ dense_b
    assert list(zip(c.row, c.col)) == [(0, 1), (1, 0), (1, 2), (2, 0), (2, 2)]
    assert c.val.dtype == np.float64 and np.array_equal(c.val, want[c.row, c.col])
    assert c.val[3] == 0.0  # 1·4 - 1·4: structural, kept
    ops = [random_coo(30, 40, 0.2, seed=48), random_coo(40, 35, 0.2, seed=49),
           random_coo(35, 20, 0.2, seed=50)]
    ops = [COO(o.row, o.col, rng.standard_normal(o.nnz).astype(np.float32), o.shape)
           for o in ops]
    exact = chain_product(ops)
    dense3 = [o.todense().astype(np.float64) for o in ops]
    assert np.allclose(exact.val, (dense3[0] @ dense3[1] @ dense3[2])[exact.row, exact.col],
                       rtol=1e-12, atol=1e-12)
    rounded = chain_product(ops, intermediate=torch.float32)
    mid = product(ops[0], ops[1])
    mid = COO(mid.row, mid.col, mid.val.astype(np.float32).astype(np.float64), mid.shape)
    assert np.array_equal(rounded.val, product(mid, ops[2]).val)
    with pytest.raises(ValueError, match="at least two"):
        chain_product(ops[:1])


def test_values_rebound_through_a_chain_stay_for_the_next_run():
    """``execute_chain`` with new A values binds them into stage 1, so a
    no-arg run afterwards repeats it; stage 2 keeps its own B values."""
    a, b, c = (random_coo(60, 50, 0.08, seed=51), random_coo(50, 55, 0.08, seed=52),
               random_coo(55, 40, 0.08, seed=53))
    chain = _exact(a, b).then(c)
    bv = _values(b.nnz, 54)
    got = execute_chain(chain, b_vals=bv)
    assert np.array_equal(chain.execute().data, got.data)
    want = chain_product([a, COO(b.row, b.col, bv, b.shape), c], intermediate=torch.float32)
    scale = chain_product([_abs(a), COO(b.row, b.col, np.abs(bv), b.shape), _abs(c)])
    assert np.all(np.abs(got.data - want.val) <= 1e-5 * scale.val)
