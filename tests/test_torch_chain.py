"""Port parity: element-exact output (``output="compact"``), persistence of
compact plans and device-resident chains of ``repro_torch`` (on the CPU,
the plain PyTorch path) against the JAX package with ``backend="jnp"``.

Integer arrays (structural patterns, compact maps, indptr/indices,
persisted artifacts) must equal the reference's bitwise; values bitwise
on small integers (every float32 sum exact) and within 1e-5 on random
float32. Inside the port: compact == block on the structural positions,
and a chain == its stages run one by one with a host round trip between
them, bitwise.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.schedule import (  # noqa: E402
    build_compact_map as r_build_compact_map,
    structural_product_pattern as r_structural_product_pattern,
)
from repro.kernels.gustavson_spgemm import compact_csr_indptr_impl  # noqa: E402
from repro.sparse.convert import (  # noqa: E402
    bcsr_from_coo as r_bcsr_from_coo,
    bcsv_from_coo as r_bcsv_from_coo,
)
from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache  # noqa: E402
from repro.spgemm import SpGEMMPlan as R_SpGEMMPlan  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.core.schedule import build_compact_map, structural_product_pattern  # noqa: E402
from repro_torch.kernels.gustavson_spgemm import (  # noqa: E402
    compact_csr_indptr,
    compact_row_counts,
)
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    SpGEMMChain,
    SpGEMMPlan,
    StructuralPattern,
    chain_plans,
    execute_chain,
    plan_from_structural_pattern,
    spgemm_plan,
)

BF16 = np.dtype(jnp.bfloat16)


def _int_coo(m, n, density, seed, integer=True):
    """The same canonical COO for both packages: small-integer float32
    values (exact under any summation order), or standard normals."""
    coo = r_random_coo(m, n, density, "uniform", seed=seed)
    rng = np.random.default_rng(seed + 999)
    if integer:
        vals = rng.integers(-4, 5, coo.nnz).astype(np.float32)
        coo.val = np.where(vals == 0, np.float32(1.0), vals)
    else:
        coo.val = rng.standard_normal(coo.nnz).astype(np.float32)
    coo = coo.sum_duplicates()
    return COO(coo.row, coo.col, coo.val, coo.shape), coo


def _coo(rows, cols, vals, shape):
    r, c, v = (np.asarray(rows), np.asarray(cols), np.asarray(vals, np.float32))
    return COO(r, c, v, shape), R_COO(r, c, v, shape)


# Operand pairs (port, reference) for A and B: random small-integer
# matrices at two tilings, and the reference's compact edge cases.
def _case(name):
    if name == "random":
        return _int_coo(96, 80, 0.06, 1), _int_coo(80, 72, 0.06, 51), (8, 2)
    if name == "random_t16":
        return _int_coo(96, 80, 0.06, 2), _int_coo(80, 72, 0.06, 52), (16, 4)
    if name == "empty_rows":  # rows 0-1 of A hold nothing
        return (_coo([2, 2, 17], [1, 30, 4], [2.0, -1.0, 3.0], (24, 40)),
                _int_coo(40, 32, 0.08, 9), (8, 2))
    if name == "single_nnz":  # one product element inside an 8x8 block
        return (_coo([3], [5], [2.0], (16, 16)), _coo([5], [7], [-3.0], (16, 16)), (8, 2))
    if name == "empty_product":  # disjoint patterns
        return (_coo([0], [0], [1.0], (16, 16)), _coo([9], [0], [1.0], (16, 16)), (8, 2))
    raise KeyError(name)


CASES = ["random", "random_t16", "empty_rows", "single_nnz", "empty_product"]


def _plans(name, output):
    (ta, ra), (tb, rb), (tile, group) = _case(name)
    got = spgemm_plan(ta, tb, tile=tile, group=group, device="cpu", output=output)
    want = r_spgemm_plan(ra, rb, tile=tile, group=group, backend="jnp",
                         cache=PlanCache(), output=output)
    return got, want


def _assert_map_equal(got, want):
    for f in ("gather", "indptr", "indices"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert tuple(got.shape) == tuple(want.shape)


def _assert_csr_equal(got, want, tol=0.0):
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(got.indptr, np.asarray(want.indptr))
    assert np.array_equal(got.indices, np.asarray(want.indices))
    if tol == 0:
        assert np.array_equal(got.data, np.asarray(want.data))
    else:
        np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=tol, atol=tol)


def _structural_nnz(a: COO, b: COO) -> int:
    da = np.zeros(a.shape, np.int64)
    da[a.row, a.col] = 1
    db = np.zeros(b.shape, np.int64)
    db[b.row, b.col] = 1
    return int(np.count_nonzero(da @ db))


# -- the symbolic phase: structural pattern and compact map -----------------

@pytest.mark.parametrize("name", CASES)
def test_structural_pattern_and_compact_map_bitwise(name):
    """``structural_product_pattern`` and ``build_compact_map`` give the
    reference's arrays bitwise, alone and inside a compact plan."""
    (ta, ra), (tb, rb), _ = _case(name)
    rows, cols = structural_product_pattern(ta.row, ta.col, tb.row, tb.col, ta.shape, tb.shape)
    want_rows, want_cols = r_structural_product_pattern(ra.row, ra.col, rb.row, rb.col,
                                                        ra.shape, rb.shape)
    for g, w in ((rows, want_rows), (cols, want_cols)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert rows.size == _structural_nnz(ta, tb)
    got, want = _plans(name, "compact")
    _assert_map_equal(got.compact, want.compact)
    _assert_map_equal(build_compact_map(got.assembly, rows, cols),
                      r_build_compact_map(want.assembly, want_rows, want_cols))
    _assert_map_equal(got.assembly, want.assembly)


@pytest.mark.parametrize("fault,match", [
    ("outside", "outside"),
    ("unsorted", "strictly ascending"),
    ("not_subset", "not a subset"),
])
def test_compact_map_rejects_bad_patterns(fault, match):
    (ta, _), (tb, _), _ = _case("random")
    plan = spgemm_plan(ta, tb, tile=8, group=2, device="cpu")
    rows, cols = structural_product_pattern(ta.row, ta.col, tb.row, tb.col, ta.shape, tb.shape)
    if fault == "outside":
        cols = cols.copy()
        cols[0] = ta.shape[0] + tb.shape[1]
    elif fault == "unsorted":
        rows, cols = rows[::-1].copy(), cols[::-1].copy()
    else:
        a1 = COO([0], [0], [1.0], (16, 16))
        plan = spgemm_plan(a1, COO([0], [0], [1.0], (16, 16)), tile=8, group=2, device="cpu")
        rows, cols = np.array([9]), np.array([9])
    with pytest.raises(ValueError, match=match):
        build_compact_map(plan.assembly, rows, cols)


@pytest.mark.parametrize("output", ["block", "compact"])
def test_device_indptr_matches_reference(output):
    """``compact_row_counts`` / ``compact_csr_indptr`` equal the reference's
    segment-sum + cumsum on the same row ids, and the plan's
    ``device_indptr`` equals its host indptr."""
    got, want = _plans("random", output)
    asm = got._active()
    row_ids = np.repeat(np.arange(asm.shape[0]), np.diff(asm.indptr))
    indptr = compact_csr_indptr(torch.from_numpy(row_ids), m=asm.shape[0])
    ref = np.asarray(compact_csr_indptr_impl(jnp.asarray(row_ids.astype(np.int32)),
                                             m=asm.shape[0]))
    assert indptr.dtype == torch.int32 and np.array_equal(indptr.numpy(), ref)
    assert np.array_equal(compact_row_counts(torch.from_numpy(row_ids), m=asm.shape[0]).numpy(),
                          np.diff(ref))
    assert np.array_equal(got.device_indptr().numpy(), np.asarray(want.device_indptr()))
    assert np.array_equal(got.device_indptr().numpy(), asm.indptr.astype(np.int32))


# -- compact output -----------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_compact_matches_reference_and_block(name):
    """Compact execute equals the reference's compact execute bitwise
    (small integers), holds exactly the structural nonzeros, and expands
    to the block plan's dense result bitwise."""
    got, want = _plans(name, "compact")
    block = spgemm_plan(got.a_pattern, got.b_pattern, tile=got.report.tile,
                        group=got.report.group, device="cpu")
    rc = got.execute()
    _assert_csr_equal(rc, want.execute())
    assert rc.data.size == _structural_nnz(got.a_pattern, got.b_pattern)
    assert np.array_equal(rc.todense(), block.execute().todense())
    if name == "single_nnz":
        assert rc.data.size == 1 and block.execute().data.size == 64
        assert rc.todense()[3, 7] == np.float32(-6.0)
    if name == "empty_product":
        assert rc.data.size == 0 and rc.indptr.shape == (17,)


def test_compact_random_float_matches_reference():
    (ta, ra), (tb, rb) = _int_coo(96, 80, 0.06, 3, False), _int_coo(80, 72, 0.06, 4, False)
    got = spgemm_plan(ta, tb, tile=8, group=2, device="cpu", output="compact")
    want = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=PlanCache(),
                         output="compact")
    _assert_csr_equal(got.execute(), want.execute(), 1e-5)


@pytest.mark.parametrize("path", ["batch", "pipelined", "block_kind"])
def test_compact_vs_block_bitwise_on_every_path(path):
    """Compact == block on the structural positions through
    ``execute_batch``, the pipeline, and a block-input plan (which has no
    element pattern, so its compact map is the block map itself)."""
    (ta, _), (tb, _), _ = _case("random")
    if path == "block_kind":
        a_bcsv, _ = bcsv_from_coo(ta, (8, 8), 2)
        b_bcsr, _ = bcsr_from_coo(tb, (8, 8))
        blk = spgemm_plan(a_bcsv, b_bcsr, device="cpu")
        cmp_ = spgemm_plan(a_bcsv, b_bcsr, device="cpu", output="compact")
        assert cmp_.compact is cmp_.assembly
        assert np.array_equal(blk.execute().todense(), cmp_.execute().todense())
        return
    blk = spgemm_plan(ta, tb, tile=8, group=2, device="cpu")
    cmp_ = spgemm_plan(ta, tb, tile=8, group=2, device="cpu", output="compact")
    rng = np.random.default_rng(0)
    av = rng.integers(-3, 4, (3, ta.nnz)).astype(np.float32)
    bv = rng.integers(-3, 4, (3, tb.nnz)).astype(np.float32)
    if path == "batch":
        outs = cmp_.execute_batch(av, bv)
    else:
        outs = list(cmp_.execute_stream(zip(av, bv), depth=2))
    for i, oc in enumerate(outs):
        assert oc.data.size == cmp_.compact.nnz < blk.assembly.nnz
        assert np.array_equal(blk.execute(av[i], bv[i]).todense(), oc.todense())
        assert np.array_equal(cmp_.execute(av[i], bv[i]).data, oc.data)


@pytest.mark.parametrize("kind", ["element", "block"])
@pytest.mark.parametrize("output", ["block", "compact"])
def test_persist_artifacts_match_reference(kind, output):
    """``persist_artifacts`` writes the reference's arrays bitwise (the
    compact map under ``casm.``) and its meta but for the backend's name;
    ``from_artifacts`` of either package's artifacts executes bitwise
    like the plan itself."""
    (ta, ra), (tb, rb), _ = _case("random")
    if kind == "element":
        got = spgemm_plan(ta, tb, tile=8, group=2, device="cpu", output=output)
        want = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=PlanCache(),
                             output=output)
        vals = dict(a_vals=ta.val, b_vals=tb.val, a_pattern=ta, b_pattern=tb)
    else:
        a_bcsv, b_bcsr = bcsv_from_coo(ta, (8, 8), 2)[0], bcsr_from_coo(tb, (8, 8))[0]
        got = spgemm_plan(a_bcsv, b_bcsr, device="cpu", output=output)
        want = r_spgemm_plan(r_bcsv_from_coo(ra, (8, 8), 2)[0], r_bcsr_from_coo(rb, (8, 8))[0],
                             backend="jnp", cache=PlanCache(), output=output)
        vals = dict(a_blocks=a_bcsv.blocks, b_blocks=b_bcsr.blocks)
    arrays, meta = got.persist_artifacts()
    r_arrays, r_meta = want.persist_artifacts()
    assert sorted(arrays) == sorted(r_arrays)
    assert ("casm.gather" in arrays) == (output == "compact")
    for k in arrays:
        assert arrays[k].dtype == r_arrays[k].dtype and np.array_equal(arrays[k], r_arrays[k]), k
    assert {k: v for k, v in meta.items() if k != "backend"} == \
        {k: v for k, v in r_meta.items() if k != "backend"}
    c = got.execute()
    for arr, met in ((arrays, meta), (r_arrays, r_meta)):
        plan = SpGEMMPlan.from_artifacts(arr, met, device="cpu", output=output, **vals)
        assert plan.report.schedule_builds == 0 and plan.output == output
        if output == "compact":
            _assert_map_equal(plan.compact, want.compact)
        _assert_csr_equal(plan.execute(), c)
    # And the reference rehydrates the port's artifacts.
    r_vals = ({"a_vals": ra.val, "b_vals": rb.val, "a_pattern": ra, "b_pattern": rb}
              if kind == "element" else {"a_blocks": vals["a_blocks"], "b_blocks": vals["b_blocks"]})
    back = R_SpGEMMPlan.from_artifacts(arrays, dict(meta, backend="jnp"), backend="jnp",
                                       output=output, **r_vals)
    _assert_csr_equal(c, back.execute(), 1e-5 if kind == "block" else 0)


def test_from_artifacts_output_must_match():
    got, _ = _plans("random", "compact")
    arrays, meta = got.persist_artifacts()
    with pytest.raises(ValueError, match="persisted output 'compact' != 'block'"):
        SpGEMMPlan.from_artifacts(arrays, meta, device="cpu",
                                  a_vals=got.a_pattern.val, b_vals=got.b_pattern.val)
    with pytest.raises(ValueError, match="output must be"):
        spgemm_plan(got.a_pattern, got.b_pattern, device="cpu", output="dense")


@pytest.mark.parametrize("output", ["block", "compact"])
def test_plan_members_match_reference(output):
    """``value_shapes``, ``value_nbytes``, ``host_nbytes`` and
    ``output_pattern`` give the reference's numbers and arrays."""
    got, want = _plans("random", output)
    assert got.value_shapes() == want.value_shapes()
    assert got.value_nbytes() == want.value_nbytes()
    assert got.host_nbytes() == want.host_nbytes()
    pat, r_pat = got.output_pattern(), want.output_pattern()
    assert isinstance(pat, StructuralPattern) and pat.nnz == r_pat.nnz
    assert np.array_equal(pat.indptr, r_pat.indptr) and np.array_equal(pat.indices, r_pat.indices)
    coo, r_coo = pat.to_coo(), r_pat.to_coo()
    assert np.array_equal(coo.row, r_coo.row) and np.array_equal(coo.col, r_coo.col)
    key = coo.row.astype(np.int64) * pat.shape[1] + coo.col
    assert (np.diff(key) > 0).all()  # canonical by construction


# -- chains ---------------------------------------------------------------------

def _abc(seed, integer=True):
    return (_int_coo(64, 56, 0.07, seed, integer), _int_coo(56, 48, 0.07, seed + 1, integer),
            _int_coo(48, 40, 0.07, seed + 2, integer), _int_coo(40, 32, 0.07, seed + 3, integer))


def _chains(seed, output, stages, integer=True):
    """The same chain in both packages: A·B·C (and ·D for 3 stages)."""
    ops_ = _abc(seed, integer)[:stages + 1]
    got = spgemm_plan(ops_[0][0], ops_[1][0], tile=8, group=2, device="cpu", output=output)
    cache = PlanCache()
    want = r_spgemm_plan(ops_[0][1], ops_[1][1], tile=8, group=2, backend="jnp", cache=cache,
                         output=output)
    chain, r_chain = got, want
    for t, r in ops_[2:]:
        chain = chain.then(t)
        r_chain = r_chain.then(r, cache=cache)
    return chain, r_chain


def _round_trip(chain: SpGEMMChain):
    """Each stage executed on its own, the values crossing the host."""
    out = chain.plans[0].execute()
    for plan in chain.plans[1:]:
        out = plan.execute(a_vals=out.data)
    return out


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("output", ["block", "compact"])
def test_chain_bitwise_vs_round_trip_and_reference(stages, output):
    chain, r_chain = _chains(20 + stages, output, stages)
    assert isinstance(chain, SpGEMMChain) and len(chain.plans) == stages
    assert chain.shape == r_chain.shape
    out = chain.execute()
    _assert_csr_equal(out, _round_trip(chain))
    _assert_csr_equal(out, r_chain.execute())
    assert np.array_equal(chain.device_indptr().numpy(), out.indptr.astype(np.int32))
    pat = chain.output_pattern()
    assert np.array_equal(pat.indices, out.indices)


def test_chain_random_float_matches_reference():
    chain, r_chain = _chains(30, "compact", 3, integer=False)
    _assert_csr_equal(chain.execute(), r_chain.execute(), 1e-5)


def test_bf16_chain_rounds_intermediates_like_reference():
    """A chain of plans built on bfloat16 values rounds each intermediate
    to the next stage's value dtype, as the reference does: bitwise with
    it and with the host round trip on small integers."""
    (ta, ra), (tb, rb), (tc, rc), _ = _abc(40)

    def bf16(t, r, scale=1.0):
        v = (t.val * np.float32(scale)).astype(BF16)  # integers up to 148: exact
        return COO(t.row, t.col, v, t.shape), R_COO(r.row, r.col, v, r.shape)

    (ta, ra), (tb, rb), (tc, rc) = bf16(ta, ra, 37.0), bf16(tb, rb), bf16(tc, rc)
    chain = spgemm_plan(ta, tb, tile=8, group=2, device="cpu", output="compact").then(tc)
    assert chain.plans[1].value_dtypes == (torch.bfloat16, torch.bfloat16)
    cache = PlanCache()
    r_chain = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=cache,
                            output="compact").then(rc, cache=cache)
    out = chain.execute()
    _assert_csr_equal(out, r_chain.execute())
    _assert_csr_equal(out, _round_trip(chain))
    # The intermediate is rounded: some of stage 1's float32 values need
    # more than bf16's 8-bit significand.
    stage1 = chain.plans[0].execute().data
    assert not np.array_equal(stage1, torch.from_numpy(stage1).bfloat16().float().numpy())


def test_empty_intermediate_product():
    """A structurally empty intermediate flows zeros through the rest of
    the chain."""
    (ta, _), (tb, _), _ = _case("empty_product")
    tc, _ = _int_coo(16, 16, 0.2, 52)
    chain = spgemm_plan(ta, tb, tile=8, group=2, device="cpu", output="compact").then(tc)
    out = chain.execute()
    assert out.data.size == 0 and np.count_nonzero(out.todense()) == 0
    assert chain.plans[1]._run_packed_chained(None) is None


def test_chain_intermediates_are_tensors_on_the_plan_device():
    chain, _ = _chains(50, "compact", 2)
    packed = chain.plans[0]._run_packed()
    assert isinstance(packed, torch.Tensor) and packed.device == chain.plans[0].device
    nxt = chain.plans[1]._run_packed_chained(packed)
    assert isinstance(nxt, torch.Tensor) and nxt.device == chain.plans[1].device
    assert np.array_equal(chain.plans[1]._wrap_packed(nxt).data, chain.execute().data)


def test_execute_chain_accepts_lists_and_validates():
    (ta, _), (tb, _), (tc, _), _ = _abc(60)
    p1 = spgemm_plan(ta, tb, tile=8, group=2, device="cpu", output="compact")
    p2 = plan_from_structural_pattern(p1.output_pattern(), tc, tile=8, group=2, device="cpu",
                                      output="compact")
    assert np.array_equal(execute_chain([p1, p2]).data, chain_plans([p1, p2]).execute().data)
    stranger = spgemm_plan(_int_coo(64, 48, 0.07, 70)[0], tc, tile=8, group=2, device="cpu")
    with pytest.raises(ValueError, match="output pattern|A shape"):
        chain_plans([p1, stranger])
    with pytest.raises(ValueError, match="not an element plan"):
        chain_plans([p1, spgemm_plan(*[bcsv_from_coo(ta, (8, 8), 2)[0],
                                       bcsr_from_coo(tb, (8, 8))[0]], device="cpu")])
    with pytest.raises(ValueError, match="at least one plan"):
        execute_chain([])


@pytest.mark.parametrize("arg", ["cache", "mesh", "validate"])
def test_plan_from_structural_pattern_refuses_unported_arguments(arg):
    """``cache``, ``mesh`` and ``validate`` (static verification) are
    ported, and refuse an object that is not a plan cache, a mesh or one
    of ``None`` and ``"deep"``."""
    (ta, _), (tb, _), (tc, _), _ = _abc(80)
    p1 = spgemm_plan(ta, tb, tile=8, group=2, device="cpu")
    error = ValueError if arg == "validate" else TypeError
    with pytest.raises(error, match="validate" if arg == "validate" else "PlanCache|Mesh"):
        plan_from_structural_pattern(p1.output_pattern(), tc, device="cpu", **{arg: object()})
