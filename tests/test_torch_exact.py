"""Element-granularity SpGEMM plans of ``repro_torch`` (``output="exact"``,
tile 1, group 1) on the CPU, the plain PyTorch path: C against the numpy
row-wise Gustavson oracle on small graph, fem and circuit patterns, a
rectangular A·B, empty rows and an entry whose run holds many pairs; the
vectorized element builder against the block builder at tile 1 (the same
runs, the same C pattern); the refusals (tile or group other than 1, and
the sharded, persistence and autotune entries; chains of exact plans are
``tests/test_torch_exact_chain.py``'s); the spans and the
``pairs`` count; batch, pipeline and cache behaviour; the plain
version's element chain; and, where JAX is installed, the element builder
and C against the JAX package's block builder at tile 1 and its oracle."""
import numpy as np
import pytest
import torch

from repro_torch.core.gustavson import spgemm_gustavson
from repro_torch.core.schedule import (
    build_assembly_map,
    build_exact_schedule,
    build_spgemm_schedule,
    exact_assembly_map,
    structural_product_pattern,
)
from repro_torch.kernels import ref
from repro_torch.kernels.gustavson_spgemm import spgemm_scheduled, stage_runs
from repro_torch.runtime import heartbeat as hb
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo
from repro_torch.sparse.formats import COO, CSR
from repro_torch.sparse.random import random_coo
from repro_torch.spgemm import (
    PlanCache,
    SpGEMMPlan,
    schedule_build_count,
    spgemm_plan,
)

SCHEDULE_FIELDS = ("a_slot", "b_slot", "panel", "sub_row", "start", "panel_group",
                   "panel_bcol", "c_brow", "c_bcol", "group", "grid_m", "grid_n", "grid_k")


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


def _check_against_oracle(a: COO, b: COO, av, bv):
    """C of an exact plan: the structural product pattern, and values
    within 1e-5 of the oracle's (each entry's error over the sum of its
    products' magnitudes, as the benchmark measures it)."""
    c = _exact(a, b).execute(av, bv)
    rows, cols = structural_product_pattern(a.row, a.col, b.row, b.col, a.shape, b.shape)
    got_rows = np.repeat(np.arange(a.shape[0]), np.diff(c.indptr))
    assert np.array_equal(got_rows, rows) and np.array_equal(c.indices, cols)
    oracle = spgemm_gustavson(CSR.from_coo(COO(a.row, a.col, av, a.shape)),
                              CSR.from_coo(COO(b.row, b.col, bv, b.shape)))
    want = oracle.todense()[rows, cols]
    mag = spgemm_gustavson(CSR.from_coo(COO(a.row, a.col, np.abs(av), a.shape)),
                           CSR.from_coo(COO(b.row, b.col, np.abs(bv), b.shape)))
    mag = mag.todense()[rows, cols]
    assert np.all(np.abs(c.data - want) <= 1e-5 * np.maximum(mag, 1e-30))
    return c


@pytest.mark.parametrize("structure", ["graph", "fem", "circuit"])
def test_exact_square_products_match_the_oracle(structure):
    a = random_coo(400, 400, 0.02, structure, seed=1)
    av = _values(a.nnz, 2)
    _check_against_oracle(a, a, av, av)


def test_exact_rectangular_product_matches_the_oracle():
    a = random_coo(70, 110, 0.05, "uniform", seed=3)
    b = random_coo(110, 45, 0.06, "uniform", seed=4)
    c = _check_against_oracle(a, b, _values(a.nnz, 5), _values(b.nnz, 6))
    assert c.shape == (70, 45)


def test_exact_empty_rows_and_an_empty_product():
    """Rows of A without entries, rows whose entries meet only empty rows
    of B, and a product without any pair (no kernel, an empty C)."""
    rng = np.random.default_rng(7)
    d = (rng.random((60, 50)) < 0.1) * rng.standard_normal((60, 50))
    d[::3] = 0  # empty rows of A
    e = (rng.random((50, 40)) < 0.1) * rng.standard_normal((50, 40))
    e[::2] = 0  # empty rows of B
    a, b = COO.fromdense(d.astype(np.float32)), COO.fromdense(e.astype(np.float32))
    c = _check_against_oracle(a, b, a.val, b.val)
    assert (np.diff(c.indptr)[::3] == 0).all()
    z = COO.fromdense(np.zeros((50, 40), np.float32) + np.eye(50, 40, 45, dtype=np.float32))
    a2 = COO.fromdense(np.eye(60, 50, dtype=np.float32))
    empty = _exact(a2, z).execute(a2.val, z.val)
    assert empty.data.shape == (0,) and (empty.indptr == 0).all()


def test_an_entry_whose_run_holds_many_pairs():
    """C[0, 0] sums 300 pairs (a full row of A against a full column of
    B): its value is the float32 chain over k ascending, one rounding a
    step (the kernel's FMA chain), and within 1e-5 of the float64 sum."""
    k = 300
    rng = np.random.default_rng(8)
    d = np.zeros((5, k), np.float32)
    d[0] = rng.standard_normal(k)
    d[3, ::7] = rng.standard_normal(len(range(0, k, 7)))
    e = np.zeros((k, 4), np.float32)
    e[:, 0] = rng.standard_normal(k)
    e[::5, 2] = 1.0
    a, b = COO.fromdense(d), COO.fromdense(e)
    plan = _exact(a, b)
    runs = stage_runs(plan.schedule, "cpu")
    assert int((runs.ptr[1] - runs.ptr[0]).item()) == k
    c = plan.execute(a.val, b.val)
    chain = np.float32(0)
    for x, y in zip(d[0].astype(np.float64), e[:, 0].astype(np.float64)):
        chain = np.float32(np.float64(chain) + x * y)
    assert c.data[0] == chain
    exact = float(np.dot(d[0].astype(np.float64), e[:, 0].astype(np.float64)))
    assert abs(c.data[0] - exact) <= 1e-5 * float(np.abs(d[0]) @ np.abs(e[:, 0]))
    _check_against_oracle(a, b, a.val, b.val)


@pytest.mark.parametrize("structure,seed", [("graph", 11), ("fem", 12), ("circuit", 13),
                                            ("uniform", 14)])
def test_the_element_builder_equals_the_block_builder_at_tile_1(structure, seed):
    a = random_coo(150, 120, 0.04, structure, seed=seed)
    b = random_coo(120, 130, 0.04, structure, seed=seed + 100)
    block = build_spgemm_schedule(bcsv_from_coo(a, (1, 1), 1)[0], bcsr_from_coo(b, (1, 1))[0])
    exact = build_exact_schedule(a.row, a.col, b.row, b.col, a.shape, b.shape)
    for f in SCHEDULE_FIELDS:
        x, y = np.asarray(getattr(block, f)), np.asarray(getattr(exact, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for x, y in zip(stage_runs(block, "cpu").__dict__.values(),
                    stage_runs(exact, "cpu").__dict__.values()):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    shape = (a.shape[0], b.shape[1])
    m1, m2 = build_assembly_map(block, (1, 1), shape), exact_assembly_map(exact, shape)
    for f in ("gather", "indptr", "indices"):
        x, y = getattr(m1, f), getattr(m2, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    # The plan's scatters at tile 1 are the identity, as the converters give.
    assert np.array_equal(bcsv_from_coo(a, (1, 1), 1)[1], np.arange(a.nnz))
    assert np.array_equal(bcsr_from_coo(b, (1, 1))[1], np.arange(b.nnz))


@pytest.mark.parametrize("tile,group", [(16, 1), (1, 4), ((1, 1, 2), 1), ((2, 1), 1)])
def test_exact_takes_tile_1_and_group_1_only(tile, group):
    a = random_coo(30, 30, 0.1, seed=15)
    with pytest.raises(ValueError, match="output='exact' takes tile=1, group=1"):
        spgemm_plan(a, a, tile=tile, group=group, output="exact", device="cpu",
                    cache=PlanCache())


@pytest.mark.parametrize("entry", ["sharded", "persist", "from_artifacts", "autotune"])
def test_entries_not_served_on_exact_plans_raise(entry):
    from repro_torch.launch.mesh import make_shard_mesh

    a = random_coo(40, 40, 0.08, seed=16)
    plan = _exact(a, a)
    calls = {
        "sharded": lambda: spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu",
                                       mesh=make_shard_mesh(2, devices=["cpu"] * 2),
                                       cache=PlanCache()),
        "persist": plan.persist_artifacts,
        "from_artifacts": lambda: SpGEMMPlan.from_artifacts(
            {}, {"kind": "element", "output": "exact"}, device="cpu", output="exact"),
        "autotune": lambda: spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu",
                                        autotune=True, cache=PlanCache()),
    }
    with pytest.raises(ValueError, match="output='exact' plans do not serve"):
        calls[entry]()


def test_block_inputs_are_refused():
    from repro_torch.sparse.convert import to_bcsr, to_bcsv

    d = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError, match="output='exact' plans do not serve"):
        spgemm_plan(to_bcsv(d, (1, 1), 1), to_bcsr(d, (1, 1)), tile=1, group=1,
                    output="exact", device="cpu", cache=PlanCache())


def test_the_disk_tier_stores_no_exact_plan(tmp_path):
    a = random_coo(50, 50, 0.08, seed=17)
    cache = PlanCache(disk_dir=str(tmp_path))
    plan = spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu", cache=cache)
    assert plan.output == "exact" and cache.stats.stores == 0
    av = _values(a.nnz, 18)
    again = spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu",
                        cache=PlanCache(disk_dir=str(tmp_path)))
    assert again.report.schedule_builds == 1 and again.report.loads == 0
    assert np.array_equal(again.execute(av, av).data, plan.execute(av, av).data)


def test_spans_and_the_pairs_count():
    """The symbolic phase records its stages under the block phase's span
    names; each ``execute`` records its stages, and its launch counts the
    pairs it computed: the product's pairs, no block fill."""
    a = random_coo(200, 180, 0.03, "graph", seed=19)
    b = random_coo(180, 160, 0.03, "graph", seed=20)
    hb.set_tracing(True)
    plan = _exact(a, b)
    names = {r.name for r in hb.spans()}
    assert {"spgemm.plan", "spgemm.plan.inputs", "spgemm.plan.convert", "spgemm.plan.schedule",
            "spgemm.plan.assembly", "spgemm.plan.stage"} <= names
    hb.default_recorder().clear()
    for seed in (21, 22):
        plan.execute(_values(a.nnz, seed), _values(b.nnz, seed + 10))
    got = hb.totals()["spans"]
    pairs = int(np.dot(np.bincount(a.col, minlength=180), np.bincount(b.row, minlength=180)))
    assert plan.report.num_triples == pairs > 0
    for name in ("spgemm.execute", "spgemm.execute.rebind", "spgemm.execute.upload",
                 "spgemm.execute.launch", "spgemm.execute.download", "spgemm.execute.wrap"):
        assert got[name]["count"] == 2, name
    assert got["spgemm.execute.launch"]["counts"] == {"pairs": 2 * pairs}


def test_block_plans_count_their_block_fill_as_pairs():
    a = random_coo(96, 96, 0.05, seed=23)
    plan = spgemm_plan(a, a, tile=16, group=2, device="cpu", cache=PlanCache())
    hb.set_tracing(True)
    plan.execute(a.val, a.val)
    counts = hb.totals()["spans"]["spgemm.execute.launch"]["counts"]
    assert counts == {"pairs": plan.report.num_triples * 16 ** 3}


def test_batch_pipeline_and_no_arg_execute_equal_execute_bitwise():
    a = random_coo(300, 300, 0.02, "graph", seed=24)
    plan = _exact(a, a)
    vals = np.stack([_values(a.nnz, s) for s in (25, 26, 27)])
    single = [plan.execute(v, v) for v in vals]
    for got, want in zip(plan.execute_batch(vals, vals), single):
        assert np.array_equal(got.data, want.data)
    with plan.pipeline(depth=2) as pipe:
        piped = list(pipe.stream((v, v) for v in vals))
    for got, want in zip(piped, single):
        assert np.array_equal(got.data, want.data)
    assert np.array_equal(plan.execute().data, single[-1].data)
    assert np.array_equal(single[0].indices, single[2].indices)


def test_a_rebind_never_writes_the_callers_values():
    """At tile 1 the plan's packed blocks are a copy of the values: a
    later rebind leaves the arrays it was built on, and the caller's, as
    they were."""
    a = random_coo(80, 80, 0.05, seed=28)
    built = a.val.copy()
    plan = _exact(a, a)
    v = _values(a.nnz, 29)
    kept = v.copy()
    plan.execute(v, v)
    plan.execute(_values(a.nnz, 30), _values(a.nnz, 31))
    assert np.array_equal(a.val, built) and np.array_equal(plan.a_pattern.val, built)
    assert np.array_equal(v, kept)


def test_exact_plans_are_cached_apart_and_hit_without_a_rebuild():
    a = random_coo(120, 120, 0.04, seed=32)
    cache = PlanCache()
    exact = spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu", cache=cache)
    block = spgemm_plan(a, a, tile=1, group=1, device="cpu", cache=cache)
    assert block is not exact and block.output == "block"
    builds = schedule_build_count()
    v = _values(a.nnz, 33)
    hit = spgemm_plan(COO(a.row, a.col, v, a.shape), COO(a.row, a.col, v, a.shape), tile=1,
                      group=1, output="exact", device="cpu", cache=cache)
    assert hit is exact and schedule_build_count() == builds
    assert np.array_equal(hit.execute().data, exact.execute(v, v).data)
    assert np.array_equal(block.execute(v, v).indices, hit.execute(v, v).indices)


def test_identity_maps_are_skipped_and_deep_validation_passes():
    a = random_coo(100, 100, 0.05, "graph", seed=34)
    exact = spgemm_plan(a, a, tile=1, group=1, output="exact", device="cpu",
                        cache=PlanCache(), validate="deep")
    assert exact.report.verify_report is not None
    ex = exact._executor
    assert ex.can_rebind and ex._a_inv is None and ex._b_inv is None and ex._gather is None
    assert ex.pairs == exact.report.num_triples
    block = spgemm_plan(a, a, tile=16, group=2, device="cpu", cache=PlanCache())
    bx = block._executor
    assert bx.can_rebind and bx._a_inv is not None and bx._gather is not None


def test_bfloat16_values_run_the_chain_on_their_widened_values():
    a = random_coo(150, 150, 0.03, "graph", seed=35)
    v = torch.from_numpy(_values(a.nnz, 36)).bfloat16()
    t = torch.sparse_coo_tensor(np.stack([a.row, a.col]), v, a.shape)
    plan = spgemm_plan(t, t, tile=1, group=1, output="exact", device="cpu", cache=PlanCache())
    assert plan.value_dtypes == (torch.bfloat16, torch.bfloat16)
    got = plan.execute(v, v)
    widened = v.float().numpy()
    want = _exact(a, a).execute(widened, widened)
    assert np.array_equal(got.data, want.data)


def test_the_plain_kernel_takes_tile_1():
    """``spgemm_scheduled`` on CPU tensors at 1 x 1 x 1 runs the plain
    version's element chain: within 1e-6 of the block product's einsum
    form, and it equals a loop of single calls in its batched form."""
    a = random_coo(120, 100, 0.05, "fem", seed=37)
    b = random_coo(100, 90, 0.05, "fem", seed=38)
    sch = build_exact_schedule(a.row, a.col, b.row, b.col, a.shape, b.shape)
    runs = stage_runs(sch, "cpu")
    av = torch.from_numpy(_values(a.nnz, 39)).reshape(-1, 1, 1)
    bv = torch.from_numpy(_values(b.nnz, 40)).reshape(-1, 1, 1)
    out = spgemm_scheduled(av, bv, runs)
    assert out.shape == (sch.n_panels, 1, 1)
    products = (av.reshape(-1)[runs.a_slot.long()] * bv.reshape(-1)[runs.b_slot.long()]).double()
    summed = torch.zeros(sch.n_panels, dtype=torch.float64).index_add_(0, runs.panel.long(),
                                                                       products)
    torch.testing.assert_close(out.reshape(-1).double(), summed, rtol=1e-6, atol=1e-6)
    sets_a, sets_b = torch.stack([av, 2 * av]), torch.stack([bv, -bv])
    batch = ref.spgemm_scheduled_batch_ref(
        sets_a.flatten(0, 1), sets_b.flatten(0, 1), runs.a_slot, runs.b_slot, runs.panel,
        runs.sub_row, runs.n_panels, runs.group, 2)
    for i in range(2):
        assert torch.equal(batch[i], spgemm_scheduled(sets_a[i], sets_b[i], runs))


def _plan_of(kind, a):
    """A plan of ``a @ a`` on the CPU and a cache of its own: exact, an
    element plan of block or compact output, or a block plan built from
    BCSV/BCSR."""
    if kind == "exact":
        return _exact(a, a)
    if kind == "bcsv_bcsr":
        return spgemm_plan(bcsv_from_coo(a, (8, 8), 2)[0], bcsr_from_coo(a, (8, 8))[0],
                           device="cpu", cache=PlanCache())
    return spgemm_plan(a, a, tile=8, group=2, output=kind, device="cpu", cache=PlanCache())


@pytest.mark.parametrize("kind", ["exact", "block", "compact", "bcsv_bcsr"])
def test_staged_values_stay_current_for_later_executes(kind):
    """Every kind of plan holds and stages its values one way: a no-arg
    ``execute`` reuses the last ones, after ``release_device_values`` too;
    a later one-operand rebind keeps the other's; after ``release_values``
    the plan takes values again; no staged copy aliases a caller's tensor;
    one array passed as both operands is uploaded once, two arrays both."""
    a = random_coo(150, 150, 0.04, "graph", seed=41)
    plan = _plan_of(kind, a)
    shape, shape_b = plan.value_shapes()
    assert shape_b == shape
    v1, v2, v3 = (_values(shape, s) for s in (42, 43, 44))
    want = plan.execute(v1, v2)
    assert np.array_equal(plan.execute().data, want.data)
    plan.release_device_values()
    assert np.array_equal(plan.execute().data, want.data)
    only_a = plan.execute(a_vals=v3)
    assert np.array_equal(only_a.data, _plan_of(kind, a).execute(v3, v2).data)
    plan.release_values()
    t = torch.from_numpy(v3.copy())
    got = plan.execute(t, t)
    t.mul_(2)
    assert np.array_equal(plan.execute().data, got.data)
    assert np.array_equal(got.data, _plan_of(kind, a).execute(v3, v3).data)
    hb.set_tracing(True)
    plan.execute(v1, v1)
    plan.execute(v1, v2)
    up = [r.counts["bytes"] for r in hb.spans() if r.name == "spgemm.execute.upload"]
    assert up == [v1.nbytes, 2 * v1.nbytes]


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("output,tile,group", [("exact", 1, 1), ("block", 4, 2)])
def test_values_of_a_fused_execute_reach_every_later_reader(output, tile, group):
    """The values an element plan was last given both of reach every later
    reader: a no-arg execute, a no-arg pipeline submit, a one-operand
    rebind (the other operand keeps them), and a cache hit, whose newer
    values win."""
    a = random_coo(120, 120, 0.05, "fem", seed=61)
    v1, v2, v3 = (_values(a.nnz, s) for s in (62, 63, 64))
    cache = PlanCache()

    def plan_on(av, bv, cache):
        return spgemm_plan(COO(a.row, a.col, av, a.shape), COO(a.row, a.col, bv, a.shape),
                           tile=tile, group=group, output=output, device="cpu", cache=cache)

    def fresh(av, bv):
        return plan_on(v1, v1, PlanCache()).execute(av, bv).data

    plan = plan_on(v1, v1, cache)
    want = plan.execute(v2, v3).data
    assert np.array_equal(want, fresh(v2, v3))
    assert np.array_equal(plan.execute().data, want)
    plan.execute(v3, v2)
    with plan.pipeline(depth=1) as pipe:
        assert np.array_equal(pipe.submit().result().data, fresh(v3, v2))
    plan.execute(v2, v3)
    assert np.array_equal(plan.execute(b_vals=v1).data, fresh(v2, v1))
    plan.execute(v3, v3)
    assert plan_on(v1, v2, cache) is plan
    assert np.array_equal(plan.execute().data, fresh(v1, v2))


def test_threads_executing_fused_values_leave_one_pair_staged():
    """More threads than cores execute one element plan with values of
    their own, on a short switch interval: each gets its own product, and
    the values a no-arg execute then reads are one thread's A and B
    together, never one thread's A with another's B."""
    import os
    import sys
    import threading

    a = random_coo(90, 90, 0.06, "graph", seed=71)
    plan = _exact(a, a)
    n = 2 * (os.cpu_count() or 4)
    vals = [(_values(a.nnz, 100 + i), _values(a.nnz, 200 + i)) for i in range(n)]
    want = [_exact(a, a).execute(av, bv).data for av, bv in vals]
    errors = []

    def worker(i):
        for _ in range(4):
            if not np.array_equal(plan.execute(*vals[i]).data, want[i]):
                errors.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a thread hung"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    staged = plan.execute().data
    assert any(np.array_equal(staged, w) for w in want)


def _jax():
    """The JAX package's builder, converter, formats and oracle (the test
    skips where JAX is not installed)."""
    pytest.importorskip("jax")
    from repro.core.gustavson import spgemm_gustavson as r_gustavson
    from repro.core.schedule import build_spgemm_schedule as r_build
    from repro.sparse.convert import bcsr_from_coo as r_bcsr, bcsv_from_coo as r_bcsv
    from repro.sparse.formats import COO as RCOO, CSR as RCSR

    return r_gustavson, r_build, r_bcsv, r_bcsr, RCOO, RCSR


@pytest.mark.parametrize("structure,seed", [("graph", 51), ("fem", 52), ("circuit", 53)])
def test_the_element_builder_equals_the_jax_builder_at_tile_1(structure, seed):
    """The vectorized element schedule, field by field, against the JAX
    package's block builder on the same COO patterns at tile (1, 1) and
    group 1."""
    _, r_build, r_bcsv, r_bcsr, RCOO, _ = _jax()
    a = random_coo(140, 110, 0.04, structure, seed=seed)
    b = random_coo(110, 120, 0.04, structure, seed=seed + 100)
    ra, a_scatter = r_bcsv(RCOO(a.row, a.col, a.val, a.shape), (1, 1), 1)
    rb, b_scatter = r_bcsr(RCOO(b.row, b.col, b.val, b.shape), (1, 1))
    want = r_build(ra, rb)
    got = build_exact_schedule(a.row, a.col, b.row, b.col, a.shape, b.shape)
    for f in SCHEDULE_FIELDS:
        x, y = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert x.shape == y.shape and np.array_equal(x, y), f
    assert np.array_equal(a_scatter, np.arange(a.nnz))
    assert np.array_equal(b_scatter, np.arange(b.nnz))


@pytest.mark.parametrize("structure,seed", [("graph", 54), ("fem", 55), ("circuit", 56)])
def test_exact_c_matches_the_jax_oracle(structure, seed):
    """C of an exact plan against the JAX package's row-wise Gustavson on
    the same inputs: the same pattern, each entry within 1e-5 of the sum
    of its products' magnitudes."""
    r_gustavson, _, _, _, RCOO, RCSR = _jax()
    a = random_coo(160, 130, 0.04, structure, seed=seed)
    b = random_coo(130, 150, 0.04, structure, seed=seed + 100)
    av, bv = _values(a.nnz, seed + 1), _values(b.nnz, seed + 2)
    c = _exact(a, b).execute(av, bv)

    def oracle(x, y):
        ra = RCSR.from_coo(RCOO(a.row, a.col, x, a.shape))
        rb = RCSR.from_coo(RCOO(b.row, b.col, y, b.shape))
        return r_gustavson(ra, rb)

    rows = np.repeat(np.arange(a.shape[0]), np.diff(c.indptr))
    want = np.asarray(oracle(av, bv).todense())[rows, c.indices]
    mag = np.asarray(oracle(np.abs(av), np.abs(bv)).todense())[rows, c.indices]
    structural = np.asarray(oracle(np.ones_like(av), np.ones_like(bv)).todense())
    assert np.count_nonzero(structural) == c.indices.shape[0]
    assert np.all(structural[rows, c.indices] > 0)
    assert np.all(np.abs(c.data - want) <= 1e-5 * np.maximum(mag, 1e-30))
