"""The inputs stage of ``spgemm_plan``: each distinct operand is put in
canonical row-major order once, and one already in that order skips the
sort. Held against ``COO.sum_duplicates`` of both packages (the arrays,
dtypes included), against plans built from shuffled operands with split
duplicates (the same key, schedule, assembly and C bitwise), against the
JAX package's plan and key, and for the ownership of the plan's arrays."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.spgemm import PlanCache, spgemm_plan  # noqa: E402
from repro_torch.spgemm import plan as plan_mod  # noqa: E402
from repro_torch.spgemm.cache import pattern_digest  # noqa: E402


def _int_coo(m, n, density, seed, dtype=np.float32) -> COO:
    """A canonical COO with small nonzero integer values: sums of them are
    exact in any order."""
    c = r_random_coo(m, n, density, "uniform", seed=seed)
    vals = np.random.default_rng(seed + 7).integers(1, 5, c.nnz)
    return COO(c.row, c.col, vals.astype(dtype), c.shape)


def _shuffled_split(coo: COO, seed: int) -> COO:
    """``coo`` in a random order, with a third of its entries split into
    two duplicates whose values sum exactly to the original."""
    rng = np.random.default_rng(seed)
    split = rng.random(coo.nnz) < 1 / 3
    part = np.ones(int(split.sum()), coo.val.dtype)
    row = np.concatenate([coo.row, coo.row[split]])
    col = np.concatenate([coo.col, coo.col[split]])
    val = np.concatenate([coo.val, part])
    val[:coo.nnz][split] -= part
    order = rng.permutation(row.shape[0])
    return COO(row[order], col[order], val[order], coo.shape)


def _operand(kind: str) -> COO:
    base = _int_coo(40, 30, 0.15, 3)
    if kind == "canonical":
        return base
    if kind == "shuffled":
        order = np.random.default_rng(1).permutation(base.nnz)
        return COO(base.row[order], base.col[order], base.val[order], base.shape)
    if kind == "duplicated":
        return _shuffled_split(base, 2)
    if kind == "explicit_zeros":
        val = base.val.copy()
        val[::3] = 0.0
        val[1::5] = -0.0
        return COO(base.row, base.col, val, base.shape)
    if kind == "int64_index":
        return COO(base.row.astype(np.int64), base.col.astype(np.int64),
                   base.val.astype(np.float64), base.shape)
    if kind == "ties_then_descending_row":
        # Ascending in the flat key row * cols + col when a column index is
        # out of range, yet not in row-major order.
        return COO(np.array([1, 0], np.int32), np.array([0, 40], np.int32),
                   np.array([1.0, 2.0], np.float32), (2, 30))
    if kind == "single":
        return COO(np.array([3]), np.array([4]), np.array([-0.0], np.float32), (5, 6))
    assert kind == "empty"
    return COO(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float64), (7, 9))


def _same_arrays(got: COO, want) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    for g, w in ((got.row, want.row), (got.col, want.col), (got.val, want.val)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()  # bitwise: -0.0 and +0.0 apart


KINDS = ["canonical", "shuffled", "duplicated", "explicit_zeros", "int64_index",
         "ties_then_descending_row", "single", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_the_canonical_coo_is_what_sum_duplicates_gives(kind):
    coo = _operand(kind)
    got, sorted_ = plan_mod._canonical_coo(coo)
    _same_arrays(got, coo.sum_duplicates())
    _same_arrays(got, R_COO(coo.row, coo.col, coo.val, coo.shape).sum_duplicates())
    want_sorted = kind in ("shuffled", "duplicated", "ties_then_descending_row")
    assert sorted_ == want_sorted
    if coo.nnz:
        # The plan owns its arrays: none is the caller's, nor a view of it.
        for g in (got.row, got.col, got.val):
            for c in (coo.row, coo.col, coo.val):
                assert not np.shares_memory(g, c)


def _plan_arrays(plan):
    sch, asm = plan.schedule, plan.assembly
    return ([getattr(sch, f) for f in ("a_slot", "b_slot", "panel", "sub_row", "start",
                                       "panel_group", "panel_bcol", "c_brow", "c_bcol")]
            + [asm.gather, asm.indptr, asm.indices, plan._a_scatter, plan._b_scatter])


@pytest.mark.parametrize("output,tile,group", [("block", 16, 2), ("compact", 8, 4),
                                               ("exact", 1, 1)])
def test_a_canonical_operand_plans_as_its_shuffled_copy_does(output, tile, group):
    a, b = _int_coo(64, 48, 0.08, 11), _int_coo(48, 56, 0.1, 12)
    canon = spgemm_plan(a, b, tile=tile, group=group, output=output, device="cpu",
                        cache=PlanCache())
    shuf = spgemm_plan(_shuffled_split(a, 13), _shuffled_split(b, 14), tile=tile,
                       group=group, output=output, device="cpu", cache=PlanCache())
    assert canon.report.pattern_key == shuf.report.pattern_key
    for x, y in zip(_plan_arrays(canon), _plan_arrays(shuf)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    got, other = canon.execute(), shuf.execute()
    assert np.array_equal(got.indptr, other.indptr)
    assert np.array_equal(got.indices, other.indices)
    assert got.data.tobytes() == other.data.tobytes()
    want = r_spgemm_plan(R_COO(a.row, a.col, a.val, a.shape), R_COO(b.row, b.col, b.val, b.shape),
                         tile=16, group=2, backend="jnp", cache=R_PlanCache()).execute()
    np.testing.assert_allclose(got.todense(), np.asarray(want.todense()), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["canonical", "shuffled", "duplicated", "int64_index"])
def test_the_pattern_key_is_the_digest_of_the_summed_operands(kind):
    """The key is the digest of ``sum_duplicates``' arrays, as it was
    before the stage could skip the sort, and the JAX package's key: so
    a plan persisted by either still hits."""
    a, b = _operand(kind), _int_coo(30, 20, 0.2, 5)
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache())
    sa, sb = a.sum_duplicates(), b.sum_duplicates()
    want = pattern_digest(sa.row, sa.col, sb.row, sb.col,
                          meta=("coo", sa.shape, sb.shape, str(sa.val.dtype), str(sb.val.dtype)))
    assert plan.report.pattern_key == want
    r_plan = r_spgemm_plan(R_COO(a.row, a.col, a.val, a.shape), R_COO(b.row, b.col, b.val, b.shape),
                           tile=8, group=2, backend="jnp", cache=R_PlanCache())
    assert plan.report.pattern_key == r_plan.report.pattern_key


def test_a_plan_persisted_from_shuffled_operands_loads_for_canonical_ones(tmp_path):
    a, b = _int_coo(64, 48, 0.08, 21), _int_coo(48, 56, 0.1, 22)
    first = spgemm_plan(_shuffled_split(a, 23), _shuffled_split(b, 24), tile=16, group=2,
                        device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
    cache = PlanCache(disk_dir=str(tmp_path))
    second = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=cache)
    assert cache.stats.disk_hits == 1 and second.report.schedule_builds == 0
    assert second.execute().data.tobytes() == first.execute().data.tobytes()


@pytest.mark.parametrize("output,tile,group", [("block", 16, 2), ("exact", 1, 1)])
def test_changing_the_callers_arrays_after_the_build_changes_nothing(output, tile, group):
    a = _int_coo(64, 64, 0.08, 31)
    plan = spgemm_plan(a, a, tile=tile, group=group, output=output, device="cpu",
                       cache=PlanCache())
    before = plan.execute()
    saved = [x.copy() for x in (plan.a_pattern.row, plan.a_pattern.col, plan.a_pattern.val)]
    a.row[:] = a.row[::-1]
    a.col[:] = 0
    a.val[:] = 99.0
    assert all(np.array_equal(x, y) for x, y in zip(
        (plan.a_pattern.row, plan.a_pattern.col, plan.a_pattern.val), saved))
    after = plan.execute()
    assert np.array_equal(after.indices, before.indices)
    assert after.data.tobytes() == before.data.tobytes()


@pytest.fixture
def canonicalized(monkeypatch):
    """The operands each plan build canonicalized."""
    seen = []
    inner = plan_mod._canonical_coo

    def counting(coo):
        seen.append(coo)
        return inner(coo)

    monkeypatch.setattr(plan_mod, "_canonical_coo", counting)
    return seen


def _build(a, b):
    return spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache())


def test_one_operand_passed_twice_is_canonicalized_once(canonicalized):
    a = _int_coo(40, 40, 0.1, 41)
    plan = _build(a, a)
    assert len(canonicalized) == 1 and plan.a_pattern is plan.b_pattern
    canonicalized.clear()
    plan = _build(COO(a.row, a.col, a.val, a.shape), COO(a.row, a.col, a.val, a.shape))
    assert len(canonicalized) == 1 and plan.a_pattern is plan.b_pattern
    canonicalized.clear()
    shuffled = _operand("shuffled")
    square = COO(shuffled.row, shuffled.col, shuffled.val, (40, 40))
    plan = _build(square, square)
    assert len(canonicalized) == 1
    _same_arrays(plan.b_pattern, square.sum_duplicates())


def test_distinct_operands_are_canonicalized_apart(canonicalized):
    a = _int_coo(40, 40, 0.1, 42)
    copy = COO(a.row.copy(), a.col.copy(), a.val.copy(), a.shape)
    plan = _build(a, copy)
    assert len(canonicalized) == 2 and plan.a_pattern is not plan.b_pattern
    canonicalized.clear()
    # The same index arrays with other values: another operand.
    plan = _build(a, COO(a.row, a.col, a.val * 2, a.shape))
    assert len(canonicalized) == 2
    assert np.array_equal(plan.b_pattern.val, a.val * 2)
    canonicalized.clear()
    # The same arrays under another shape: another operand.
    _build(COO(a.row, a.col, a.val, (40, 40)), COO(a.row, a.col, a.val, (40, 48)))
    assert len(canonicalized) == 2


def test_a_and_a_give_the_product_of_two_copies_bitwise():
    a = _int_coo(48, 48, 0.09, 51)
    copy = COO(a.row.copy(), a.col.copy(), a.val.copy(), a.shape)
    one, two = _build(a, a), _build(a, copy)
    assert one.report.pattern_key == two.report.pattern_key
    assert one.execute().data.tobytes() == two.execute().data.tobytes()
    vals = np.arange(1, a.nnz + 1, dtype=np.float32) % 7
    assert one.execute(vals, vals).data.tobytes() == two.execute(vals, vals).data.tobytes()
