"""Port parity: sharded SpGEMM plans of ``repro_torch`` (on the CPU, every
shard on ``cpu``) against the JAX package and against the port's own
single-device plan.

* The partitioner (``core/schedule.py``: ``partition_spgemm_schedule``,
  ``shard_from_group_range``, the bound codecs, ``stack_shard_schedules``,
  and ``pad_schedule_arrays``) is a numpy copy of the reference's and
  equals it bitwise at 1/2/3/4/5/8 shards, empty shards included.
* A :class:`ShardedSpGEMMPlan` equals the single-device plan bitwise at
  1/2/4/8 shards: ``execute`` (staged and fresh values), ``execute_batch``,
  compact output and the pipeline, with small-integer values and with
  random floats (each output tile sums the same triples in the same
  order); its results equal the reference's ``jnp`` plan within 1e-5.
* Sharded plans persist and rehydrate, and the cache key carries the mesh.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core import schedule as r_schedule  # noqa: E402
from repro.kernels.gustavson_spgemm import pad_schedule_arrays as r_pad_schedule_arrays  # noqa: E402,E501
from repro.sparse.convert import (  # noqa: E402
    bcsr_from_coo as r_bcsr_from_coo,
    bcsv_from_coo as r_bcsv_from_coo,
)
from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.data.pipeline import SpGEMMValueStream  # noqa: E402
from repro_torch.kernels.gustavson_spgemm import pad_schedule_arrays  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_shard_mesh  # noqa: E402
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo, to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.sparse.random import random_block_sparse, suite_matrix  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    PlanCache,
    ShardedSpGEMMPlan,
    SpGEMMPlan,
    schedule_build_count,
    spgemm_plan,
)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers side by side, and many threads per worker contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHARD_FIELDS = ("group_lo", "group_hi", "triple_lo", "triple_hi", "panel_lo", "panel_hi",
                "a_lo", "a_hi")
SCHED_FIELDS = ("a_slot", "b_slot", "panel", "sub_row", "start", "panel_group", "panel_bcol",
                "c_brow", "c_bcol")


def _coo(m, n, density, seed, integer=True):
    """The same canonical COO for both packages: small integers (every
    float32 sum exact) or standard normals."""
    coo = r_random_coo(m, n, density, "uniform", seed=seed)
    rng = np.random.default_rng(seed + 999)
    if integer:
        v = rng.integers(-4, 5, coo.nnz).astype(np.float32)
        coo.val = np.where(v == 0, np.float32(1.0), v)
    else:
        coo.val = rng.standard_normal(coo.nnz).astype(np.float32)
    coo = coo.sum_duplicates()
    return COO(coo.row, coo.col, coo.val, coo.shape), coo


def _schedules(m=200, n=160, density=0.05, seed=3, tile=8, group=2):
    (a, ra) = _coo(m, n, density, seed)
    b = COO(a.col, a.row, a.val, (n, m))
    rb = R_COO(a.col, a.row, a.val, (n, m))
    mine = schedule.build_spgemm_schedule(bcsv_from_coo(a, (tile, tile), group)[0],
                                          bcsr_from_coo(b, (tile, tile))[0])
    ref = r_schedule.build_spgemm_schedule(r_bcsv_from_coo(ra, (tile, tile), group)[0],
                                           r_bcsr_from_coo(rb, (tile, tile))[0])
    return mine, ref


def _mesh(n):
    return make_shard_mesh(n, devices=["cpu"] * n)


def _assert_csr_equal(got, want):
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# -- the partitioner ---------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5, 8, 40])
def test_partition_equals_the_reference_bitwise(n_shards):
    mine, ref = _schedules()
    got = schedule.partition_spgemm_schedule(mine, n_shards)
    want = r_schedule.partition_spgemm_schedule(ref, n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        for f in SHARD_FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        for f in SCHED_FIELDS:
            x, y = getattr(g.schedule, f), getattr(w.schedule, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        for f in ("group", "grid_m", "grid_n", "grid_k"):
            assert getattr(g.schedule, f) == getattr(w.schedule, f)
    assert np.array_equal(schedule.shards_to_bounds(got), r_schedule.shards_to_bounds(want))
    t_max = max(1, max(s.num_triples for s in got))
    p_max = max(1, max(s.n_panels for s in got))
    for x, y in zip(schedule.stack_shard_schedules(got, t_max, p_max),
                    r_schedule.stack_shard_schedules(want, t_max, p_max)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    s = got[0].schedule
    for pad_to in (None, s.num_triples + 5):
        for x, y in zip(pad_schedule_arrays(s.a_slot, s.b_slot, s.panel, s.sub_row, s.start,
                                            s.n_panels, pad_to),
                        r_pad_schedule_arrays(s.a_slot, s.b_slot, s.panel, s.sub_row, s.start,
                                              s.n_panels, pad_to)):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_balanced_boundaries_and_group_ranges_equal_the_reference():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 50):
        counts = rng.integers(0, 30, n)
        for parts in (1, 2, 5, 9):
            assert np.array_equal(schedule._balanced_boundaries(counts, parts),
                                  r_schedule._balanced_boundaries(counts, parts))
    mine, ref = _schedules(seed=9)
    for lo, hi in ((0, 3), (2, 7), (5, 5), (0, 13)):
        g = schedule.shard_from_group_range(mine, lo, hi)
        w = r_schedule.shard_from_group_range(ref, lo, hi)
        assert all(getattr(g, f) == getattr(w, f) for f in SHARD_FIELDS)


def test_slices_reconstruct_the_parent_and_empty_shards():
    mine, _ = _schedules()
    n_groups = -(-mine.grid_m // mine.group)
    shards = schedule.partition_spgemm_schedule(mine, n_groups + 5)
    assert np.array_equal(np.concatenate([s.schedule.a_slot + s.a_lo for s in shards]),
                          mine.a_slot)
    assert np.array_equal(np.concatenate([s.schedule.panel + s.panel_lo for s in shards]),
                          mine.panel)
    empty = [s for s in shards if s.num_triples == 0]
    assert empty and all(s.n_panels == 0 and s.a_lo == s.a_hi for s in empty)
    with pytest.raises(ValueError, match="n_shards"):
        schedule.partition_spgemm_schedule(mine, 0)


@pytest.mark.parametrize("name,scale", [("poisson3Da", 0.05), ("cage12", 0.01)])
def test_triple_balance_on_paper_matrices(name, scale):
    a = suite_matrix(name, scale=scale, seed=0).to_coo().sum_duplicates()
    b = COO(a.col, a.row, a.val, (a.shape[1], a.shape[0])).sum_duplicates()
    sch = schedule.build_spgemm_schedule(bcsv_from_coo(a, (16, 16), 2)[0],
                                         bcsr_from_coo(b, (16, 16))[0])
    for n in (2, 4, 8):
        t = np.array([s.num_triples for s in schedule.partition_spgemm_schedule(sch, n)])
        assert t.sum() == sch.num_triples and t.max() / t.mean() <= 1.25


# -- sharded plans against the single plan --------------------------------------------

@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("output", ["block", "compact"])
def test_sharded_equals_single_bitwise(integer, output):
    """execute (staged and fresh values), execute_batch, the pipeline and
    device_indptr at 1/2/4/8 shards against the single plan, bitwise."""
    (a, _), (b, _) = _coo(96, 80, 0.06, 0, integer), _coo(80, 72, 0.06, 50, integer)
    single = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(), output=output)
    c0 = single.execute()
    rng = np.random.default_rng(1)
    av = rng.standard_normal((3, a.nnz)).astype(np.float32)
    bv = rng.standard_normal((3, b.nnz)).astype(np.float32)
    if integer:
        av, bv = np.round(av * 2), np.round(bv * 2)
    cb0 = single.execute_batch(av, bv)
    for n in (1, 2, 4, 8):
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                           output=output, mesh=_mesh(n))
        assert isinstance(plan, ShardedSpGEMMPlan) and plan.shard_stats()["n_shards"] == n
        _assert_csr_equal(plan.execute(), c0)
        _assert_csr_equal(plan.execute(av[0], bv[0]), single.execute(av[0], bv[0]))
        for got, want in zip(plan.execute_batch(av, bv), cb0):
            _assert_csr_equal(got, want)
        with plan.pipeline(depth=2) as pipe:
            piped = list(pipe.stream((av[i], bv[i]) for i in range(3)))
        for got, want in zip(piped, cb0):
            _assert_csr_equal(got, want)
        for got, want in zip(plan.execute_async(av, bv).result(), cb0):
            _assert_csr_equal(got, want)
        assert np.array_equal(plan.device_indptr().numpy(), c0.indptr.astype(np.int32))
        plan.release_values()  # execute_batch never reads staged values
        _assert_csr_equal(plan.execute_batch(av[:1], bv[:1])[0], cb0[0])


def test_sharded_matches_the_reference_plan():
    """The sharded plan against the JAX package's single plan (jnp): the
    pattern bitwise, random-float values within 1e-5."""
    (a, ra), (b, rb) = _coo(96, 80, 0.06, 5, False), _coo(80, 72, 0.06, 55, False)
    want = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=R_PlanCache()).execute()
    for n in (1, 4):
        got = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                          mesh=_mesh(n)).execute()
        assert np.array_equal(got.indptr, want.indptr)
        assert np.array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=1e-5, atol=1e-5)


def test_ragged_empty_and_block_plans():
    """Five block-row groups over 2/4 shards (ragged) and 8 (empty
    shards launch nothing), and BCSV/BCSR plans sharded over packed block
    slices."""
    (a, _) = _coo(77, 63, 0.09, 11)
    b = COO(a.col, a.row, a.val, (63, 77))
    c0 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache()).execute()
    for n in (2, 4, 8):
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(), mesh=_mesh(n))
        triples = plan.shard_stats()["triples"]
        if n == 8:
            assert 0 in triples
        assert plan._executor.n_launching == sum(t > 0 for t in triples)
        _assert_csr_equal(plan.execute(), c0)
    ad = random_block_sparse(96, 96, (16, 16), 0.4, seed=21)
    bd = random_block_sparse(96, 96, (16, 16), 0.4, seed=22)
    ab, bb = to_bcsv(ad, (16, 16), 2), to_bcsr(bd, (16, 16))
    single = spgemm_plan(ab, bb, device="cpu", cache=PlanCache())
    c_single = single.execute()
    av = np.stack([ab.blocks, ab.blocks * 2.0])
    bv = np.stack([bb.blocks, bb.blocks])
    cb_single = single.execute_batch(av, bv)
    for n in (2, 8):
        plan = spgemm_plan(ab, bb, device="cpu", cache=PlanCache(), mesh=_mesh(n))
        _assert_csr_equal(plan.execute(), c_single)
        for got, want in zip(plan.execute_batch(av, bv), cb_single):
            _assert_csr_equal(got, want)
        with plan.pipeline(depth=2) as pipe:
            got = pipe.submit(av[1], bv[1]).result()
        _assert_csr_equal(got, cb_single[1])
        _assert_csr_equal(plan.execute(av[1], bv[1]), cb_single[1])


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_stream_matches_sequential(shards):
    a = suite_matrix("poisson3Da", scale=0.02, seed=0).to_coo().sum_duplicates()
    b = COO(a.col, a.row, a.val, (a.shape[1], a.shape[0]))
    plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                       mesh=_mesh(shards))
    stream = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=3)
    seq = [plan.execute(*stream.values_at(s)) for s in range(4)]
    for depth in (1, 2, 4):
        with plan.pipeline(depth=depth) as pipe:
            out = list(pipe.stream(stream.values_at(s) for s in range(4)))
        for c_seq, c_pipe in zip(seq, out):
            _assert_csr_equal(c_pipe, c_seq)
    av, bv = stream.values_batch_at(0, batch=3)
    for w, g in zip(plan.execute_batch(av, bv), plan.execute_async(av, bv).result()):
        _assert_csr_equal(g, w)


def test_chain_from_a_sharded_plan():
    (a, _), (b, _), (c, _) = _coo(64, 56, 0.07, 20), _coo(56, 48, 0.07, 21), \
        _coo(48, 40, 0.07, 22)
    single = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                         output="compact").then(c, cache=PlanCache())
    sharded = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                          output="compact", mesh=_mesh(4)).then(c, cache=PlanCache())
    _assert_csr_equal(sharded.execute(), single.execute())


# -- persistence, cache keys, meshes ----------------------------------------------

@pytest.mark.parametrize("output", ["block", "compact"])
def test_sharded_persist_and_rehydrate(output, tmp_path):
    (a, _), (b, _) = _coo(96, 80, 0.06, 30), _coo(80, 72, 0.06, 80)
    mesh = _mesh(4)
    cold = spgemm_plan(a, b, tile=8, group=2, device="cpu", output=output, mesh=mesh,
                       cache=PlanCache(disk_dir=str(tmp_path)))
    builds = schedule_build_count()
    warm = spgemm_plan(a, b, tile=8, group=2, device="cpu", output=output, mesh=mesh,
                       cache=PlanCache(disk_dir=str(tmp_path)))
    assert isinstance(warm, ShardedSpGEMMPlan) and schedule_build_count() == builds
    assert warm.report.loads == 1 and warm.shard_stats() == cold.shard_stats()
    _assert_csr_equal(warm.execute(), cold.execute())
    arrays, meta = cold.persist_artifacts()
    with pytest.raises(ValueError, match="persisted shards"):
        SpGEMMPlan.from_artifacts(arrays, meta, device="cpu", a_vals=cold.a_pattern.val,
                                  b_vals=cold.b_pattern.val, a_pattern=cold.a_pattern,
                                  b_pattern=cold.b_pattern, output=output, mesh=_mesh(2))
    flat = SpGEMMPlan.from_artifacts(arrays, meta, device="cpu", a_vals=cold.a_pattern.val,
                                     b_vals=cold.b_pattern.val, output=output)
    assert not isinstance(flat, ShardedSpGEMMPlan)
    _assert_csr_equal(flat.execute(), cold.execute())


def test_mesh_rules():
    m = make_shard_mesh(3, devices=["cpu", "cpu", "cpu", "cpu"])
    assert m.shape == {"shard": 3} and m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="out of range"):
        make_shard_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="out of range"):
        make_shard_mesh(0, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_shard_mesh(2)
    with pytest.raises(ValueError, match="one axis"):
        Mesh((torch.device("cpu"),), ("a", "b"))
    (a, _), (b, _) = _coo(48, 40, 0.1, 1), _coo(40, 48, 0.1, 2)
    with pytest.raises(ValueError, match="no axis"):
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(), mesh=_mesh(2),
                    mesh_axis="model")
    with pytest.raises(TypeError, match="Mesh"):
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(), mesh=object())
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                       mesh=make_shard_mesh(2, "rows", devices=["cpu"] * 2))
    assert plan.mesh_axis == "rows" and plan.device == torch.device("cpu")
    assert plan.host_nbytes() > SpGEMMPlan.host_nbytes(plan)
