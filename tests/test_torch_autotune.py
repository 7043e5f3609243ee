"""Port parity: the per-pattern plan autotuner (``spgemm/autotune.py``) and
its plumbing in ``spgemm/plan.py``, on the CPU.

* **Against the reference.** Under one scripted fake clock, the port's
  search (plain version, ``device="cpu"``) and the JAX package's (backend
  ``jnp``) give the same :class:`TunedConfig` record, ``to_meta()`` for
  ``to_meta()``, on an element plan and on a block-input plan: the same
  grid, the same roofline ranking from the same schedule counts, the same
  survivors, probes and winner. The grid, the chunk candidates and the
  ranking agreement are held equal on their own as well.
* **Inside the port** (the reference's invariants, ``tests/test_autotune.py``):
  the requested config survives pruning; the winner's chunk and depth land
  on the plan; a tuned config round-trips through the disk sidecar and the
  plan artifact; a warm restart applies it with zero probes, in process
  and in a second plain Python process; the env override and stale
  configs keep their provenance; a tuned plan is bitwise equal to an
  untuned plan at the winner's (tile, group) on ``execute``,
  ``execute_batch`` and ``execute_stream``, sharded too; compact output
  is refused.
* **The card's grid.** On the ``cuda`` backend the default grid keeps only
  the tiles K1 takes, and a refused tile asked for explicitly raises.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.sparse.convert import to_bcsr as r_to_bcsr, to_bcsv as r_to_bcsv  # noqa: E402
from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import autotune as rat  # noqa: E402
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.sparse.random import random_block_sparse, random_coo, suite_matrix  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    PlanCache,
    SpGEMMGateway,
    SpGEMMPlan,
    TunedConfig,
    autotune_plan,
    probe_run_count,
    spgemm_plan,
)
from repro_torch.spgemm import autotune as at  # noqa: E402
from repro_torch.spgemm.executor import CHUNK_BYTES_ENV, resolve_chunk_bytes  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


class FakeTimer:
    """A perf_counter stand-in scripted by per-measurement durations: every
    second call (a measurement's stop) advances the clock by the next
    duration, so measurement k reads ``durations[k]`` seconds."""

    def __init__(self, durations):
        self.durations = [float(d) for d in durations]
        self.t = 0.0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls % 2 == 0:
            self.t += self.durations.pop(0)
        return self.t


def _int_coo(m, n, density, seed):
    """Small-integer float32 values, never zero: exact in float32, so
    tuned-against-untuned comparisons can demand bitwise equality."""
    coo = random_coo(m, n, density, "uniform", seed=seed)
    rng = np.random.default_rng(seed + 999)
    vals = rng.integers(-4, 5, coo.nnz).astype(np.float32)
    coo.val = np.where(vals == 0, np.float32(1.0), vals)
    return coo


def _mats(seed=7, shape=(96, 96), density=0.06):
    a = _int_coo(shape[0], shape[1], density, seed)
    b = COO(a.col, a.row, a.val, (shape[1], shape[0]))
    return a, b


def _ref(coo: COO) -> R_COO:
    return R_COO(np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.val), coo.shape)


def _same_csr(x, y):
    assert np.array_equal(x.indptr, y.indptr)
    assert np.array_equal(x.indices, y.indices)
    assert np.array_equal(x.data, y.data)


# -- the search against the reference -------------------------------------------------

@pytest.mark.parametrize("tile,group", [((64, 64, 64), 4), ((16, 16, 16), 2), ((8, 8, 8), 1),
                                        ((16, 32, 64), 3), ((256, 256, 256), 8)])
def test_default_grid_equals_the_reference(tile, group):
    assert at._default_candidates(tile, group) == rat._default_candidates(tile, group)
    assert at._search_grid(tile, group, None, "torch") == rat._default_candidates(tile, group)


@pytest.mark.parametrize("req", [(64, 64, 64), (16, 16, 16), (32, 64, 128)])
def test_cuda_grid_keeps_only_tiles_the_kernel_takes(req):
    grid = at._search_grid(req, 4, None, "cuda")
    ref = [(t, g) for t, g in rat._default_candidates(req, 4)
           if all(d % 16 == 0 and 16 <= d <= 128 for d in t)]
    assert grid == ref and (req, 4) in grid
    assert all(all(d % 16 == 0 and 16 <= d <= 128 for d in t) for t, _ in grid)
    if req == (64, 64, 64):  # chip_smoke.py's grid: 9 candidates
        assert sorted({t[0] for t, _ in grid}) == [32, 64, 128]
        assert sorted({g for _, g in grid}) == [2, 4, 8]


def test_cuda_grid_refuses_tiles_the_kernel_refuses():
    with pytest.raises(ValueError, match="multiples of 16"):
        at._search_grid((16, 16, 16), 2, [((8, 8, 8), 2)], "cuda")
    with pytest.raises(ValueError, match="multiples of 16"):
        at._check_kernel_tiles([((8, 8, 8), 2)], "cuda", "requested tile")
    at._check_kernel_tiles([((8, 8, 8), 2)], "torch", "requested tile")  # plain: any tile
    assert at._search_grid((16,) * 3, 2, [((8, 8, 8), 2)], "torch") == [
        ((8, 8, 8), 2), ((16, 16, 16), 2)]


def test_chunk_candidates_equal_the_reference_on_the_cpu():
    a, b = _mats(1)
    plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    assert at._chunk_candidates(plan) == rat._chunk_candidates("jnp")


def test_ranking_agreement_equals_the_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 6):
        m, t = rng.uniform(size=n), rng.uniform(size=n)
        t[: n // 2] = t[0]  # ties
        assert at._ranking_agreement(m, t) == rat._ranking_agreement(m, t)
    assert at._ranking_agreement([1.0, 2.0, 3.0], [10.0, 20.0, 30.0]) == 1.0
    assert at._ranking_agreement([1.0, 2.0, 3.0], [30.0, 20.0, 10.0]) == 0.0
    assert at._ranking_agreement([1.0, 1.0], [10.0, 20.0]) == 0.5


def test_synthetic_batch_is_small_integers_in_the_plan_dtype():
    a, b = _mats(2)
    for dtype in (torch.float32, torch.bfloat16):
        ta = torch.sparse_coo_tensor(np.stack([a.row, a.col]), torch.tensor(a.val).to(dtype),
                                     a.shape, check_invariants=True)
        plan = spgemm_plan(ta, b, tile=16, group=2, device="cpu", cache=PlanCache())
        av, bv = at._synthetic_batch(plan, 3, seed=0)
        assert av.dtype == dtype and bv.dtype == torch.float32
        assert tuple(av.shape) == (3,) + plan.value_shapes()[0]
        ints = np.random.default_rng(0).integers(-3, 4, (3,) + plan.value_shapes()[0])
        assert np.array_equal(av.float().numpy(), ints.astype(np.float32))


def test_element_search_equals_the_reference_under_one_fake_clock():
    """The default grid around (16, 2), two survivors, three chunk
    candidates, depths 1 and 2: the port's TunedConfig record equals the
    reference's. The scripted clock makes a non-default config win."""
    a, b = _mats(3, shape=(128, 112), density=0.05)
    # Entries: <= 3 survivors x 3 chunks (9 batch measurements), then 2
    # depth measurements; durations never tie.
    durations = [0.010, 0.009, 0.011, 0.004, 0.0045, 0.006, 0.007, 0.008, 0.0085,
                 0.003, 0.002]
    kw = dict(tile=16, group=2, model_top_k=2, depth_candidates=(1, 2),
              probe_batch=2, repeats=1)
    got = autotune_plan(a, b, device="cpu", cache=PlanCache(),
                        timer=FakeTimer(durations), **kw)
    want = rat.autotune_plan(_ref(a), _ref(b), backend="jnp", cache=R_PlanCache(),
                             timer=FakeTimer(durations), **kw)
    assert got.tuned_config.to_meta() == want.tuned_config.to_meta()
    assert got.tuned_config.probes > 0 and got.tuned_config.speedup > 1.0
    assert got.report.config_source == want.report.config_source == "tuned"
    assert tuple(got.report.tile) == tuple(want.report.tile)


def test_block_input_search_equals_the_reference_under_one_fake_clock():
    """Block formats fix tile and group: only chunk and depth are searched."""
    ad = random_block_sparse(64, 64, (16, 16), 0.4, seed=31)
    bd = random_block_sparse(64, 64, (16, 16), 0.4, seed=32)
    durations = [0.003, 0.001, 0.002, 0.004, 0.005]
    kw = dict(depth_candidates=(2, 4), probe_batch=2, repeats=1)
    got = autotune_plan(to_bcsv(ad, (16, 16), 2), to_bcsr(bd, (16, 16)), device="cpu",
                        cache=PlanCache(), timer=FakeTimer(durations), **kw)
    want = rat.autotune_plan(r_to_bcsv(ad, (16, 16), 2), r_to_bcsr(bd, (16, 16)),
                             backend="jnp", cache=R_PlanCache(),
                             timer=FakeTimer(durations), **kw)
    assert got.tuned_config.to_meta() == want.tuned_config.to_meta()
    cfg = got.tuned_config
    assert cfg.tile == (16, 16, 16) and cfg.group == 2 and cfg.pipeline_depth == 2
    assert cfg.chunk_bytes == at._chunk_candidates(got)[1]


# -- the search inside the port ----------------------------------------------------------

def test_requested_config_always_survives_pruning():
    a, b = _mats(1)
    cands = [((8, 8, 8), 2), ((16, 16, 16), 2), ((32, 32, 32), 2)]
    record = {}
    plan = autotune_plan(
        a, b, tile=8, group=2, device="cpu", cache=PlanCache(), candidates=cands,
        chunk_candidates=[None], depth_candidates=(2,), model_top_k=1, probe_batch=2,
        repeats=2, timer=FakeTimer([1.0, 0.001] * 2), record=record,
    )
    cfg = plan.tuned_config
    assert (cfg.tile, cfg.group) in cands
    assert cfg.probes > 0 and cfg.default_values_per_s > 0
    assert ([8, 8, 8], 2) in [(p["tile"], p["group"]) for p in record["probes"]]
    assert len(record["candidates"]) == 3
    models = [c["model_s"] for c in record["candidates"]]
    assert models == sorted(models) and record["depths"] == {}


def test_measured_winner_and_chunk_applied():
    a, b = _mats(2)
    plan = autotune_plan(
        a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
        candidates=[((16, 16, 16), 2)], chunk_candidates=[None, 123456],
        depth_candidates=(2,), model_top_k=1, probe_batch=2, repeats=1,
        timer=FakeTimer([0.010, 0.002]),
    )
    cfg = plan.tuned_config
    assert (cfg.tile, cfg.group, cfg.chunk_bytes) == ((16, 16, 16), 2, 123456)
    assert plan._executor._chunk_policy == resolve_chunk_bytes(123456, plan.device)
    assert plan.report.config_source == "tuned" and plan.report.tuned == cfg.to_meta()
    assert cfg.values_per_s == pytest.approx(2 / 0.002)
    assert cfg.default_values_per_s == pytest.approx(2 / 0.010)
    assert cfg.speedup == pytest.approx(5.0)


def test_tuned_depth_steers_pipeline_default():
    a, b = _mats(3)
    record = {}
    plan = autotune_plan(
        a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
        candidates=[((16, 16, 16), 2)], chunk_candidates=[None], depth_candidates=(1, 4),
        model_top_k=1, probe_batch=2, repeats=1, timer=FakeTimer([0.002, 0.050, 0.001]),
        record=record,
    )
    assert plan.tuned_config.pipeline_depth == 4 and plan._default_depth() == 4
    assert record["depths"] == {1: pytest.approx(50.0), 4: pytest.approx(1.0)}
    with plan.pipeline() as pipe:
        assert pipe.depth == 4


def test_probes_count_every_timed_and_warmup_run():
    a, b = _mats(4)
    before = probe_run_count()
    plan = autotune_plan(
        a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
        candidates=[((16, 16, 16), 2)], chunk_candidates=[None, 4096],
        depth_candidates=(1, 2), model_top_k=1, probe_batch=2, repeats=2,
    )
    # (2 chunk entries + 2 depths) x (1 warmup + 2 repeats).
    assert plan.tuned_config.probes == probe_run_count() - before == 12


# -- persistence and precedence ---------------------------------------------------------

CFG = TunedConfig(
    tile=(16, 16, 16), group=2, chunk_bytes=789, pipeline_depth=4,
    values_per_s=1234.5678901234567, default_values_per_s=1000.0000000000001,
    model_rank=1, ranking_agreement=2.0 / 3.0, probes=12,
)


def test_meta_roundtrip_bitwise_and_equal_to_the_reference():
    assert TunedConfig.from_meta(CFG.to_meta()) == CFG
    ref = rat.TunedConfig.from_meta(CFG.to_meta())
    assert ref.to_meta() == CFG.to_meta()
    assert TunedConfig.from_meta(CFG.to_meta(), source="persisted").source == "persisted"


def test_sidecar_roundtrip_bitwise(tmp_path):
    key = ("pat", (16, 16, 16), 2, "torch", "cpu", None)
    c1 = PlanCache(disk_dir=str(tmp_path))
    c1.tuned_put(key, CFG.to_meta())
    assert c1.stats.tuned_stores == 1
    c2 = PlanCache(disk_dir=str(tmp_path))
    meta = c2.tuned_get(key)
    assert meta is not None and c2.stats.tuned_hits == 1
    back = TunedConfig.from_meta(meta, source="persisted")
    assert back.values_per_s == CFG.values_per_s
    assert back.ranking_agreement == CFG.ranking_agreement
    assert c2.tuned_get(("nope",)) is None and c2.stats.tuned_misses == 1


def test_plan_artifact_carries_tuned_config():
    a, b = _mats(4)
    plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    cfg = TunedConfig(tile=(16, 16, 16), group=2, chunk_bytes=55555, pipeline_depth=3,
                      values_per_s=10.0, default_values_per_s=9.0, model_rank=0,
                      ranking_agreement=1.0, probes=6)
    plan.apply_tuned_config(cfg)
    arrays, meta = plan.persist_artifacts()
    assert meta["tuned_config"] == cfg.to_meta()
    back = SpGEMMPlan.from_artifacts(arrays, meta, device="cpu",
                                     a_vals=plan.a_pattern.val, b_vals=plan.b_pattern.val)
    assert back.tuned_config.source == "persisted"
    assert back.report.config_source == "persisted"
    assert back._executor._chunk_policy == resolve_chunk_bytes(55555, "cpu")
    assert back._default_depth() == 3


def test_warm_restart_in_process_zero_probes(tmp_path):
    a, b = _mats(5)
    c1 = PlanCache(disk_dir=str(tmp_path))
    tuned = autotune_plan(
        a, b, tile=16, group=2, device="cpu", cache=c1,
        candidates=[((16, 16, 16), 2), ((32, 32, 32), 2)], chunk_candidates=[None],
        depth_candidates=(2,), model_top_k=2, probe_batch=2, repeats=1,
        timer=FakeTimer([0.004, 0.002]),
    )
    cfg = tuned.tuned_config
    before = probe_run_count()
    c2 = PlanCache(disk_dir=str(tmp_path))
    warm = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=c2, autotune=True)
    assert probe_run_count() == before, "warm restart paid probes"
    assert warm.report.config_source == "persisted" and warm.report.schedule_builds == 0
    assert tuple(warm.report.tile) == cfg.tile
    assert warm.tuned_config == TunedConfig.from_meta(cfg.to_meta(), source="persisted")
    # The sidecar is keyed by the device: the same pattern on another
    # device (here: another backend key) is searched afresh.
    key = (tuned.report.pattern_key, (16, 16, 16), 2, "torch", "cpu", None)
    assert c2.tuned_get(key) is not None
    assert c2.tuned_get(key[:4] + ("cuda:0", None)) is None


def test_env_override_beats_tuned_config(monkeypatch):
    a, b = _mats(6)
    plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    cfg = TunedConfig(tile=(16, 16, 16), group=2, chunk_bytes=999999, pipeline_depth=2,
                      values_per_s=1.0, default_values_per_s=1.0, model_rank=0,
                      ranking_agreement=1.0, probes=2)
    monkeypatch.setenv(CHUNK_BYTES_ENV, "4096")
    plan.apply_tuned_config(cfg)
    assert plan._executor._chunk_policy[0] == 4096
    assert plan.report.config_source == "env-override"
    assert plan.report.tuned == cfg.to_meta()


def test_mismatched_config_is_stale_not_fatal():
    a, b = _mats(7)
    plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    cfg = TunedConfig(tile=(8, 8, 8), group=2, chunk_bytes=None, pipeline_depth=2,
                      values_per_s=1.0, default_values_per_s=1.0, model_rank=0,
                      ranking_agreement=1.0, probes=0)
    plan.apply_tuned_config(cfg)
    assert plan.tuned_config is None and plan.report.tuned is None
    assert plan.report.config_source == "stale-tuned" and plan._stale_tuned is cfg
    ref = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    assert np.array_equal(plan.execute().data, ref.execute().data)


def test_drifted_artifact_rehydrates_on_defaults():
    a, b = _mats(8)
    a, b = a.sum_duplicates(), b.sum_duplicates()
    plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
    plan.apply_tuned_config(TunedConfig(
        tile=(16, 16, 16), group=2, chunk_bytes=4096, pipeline_depth=3, values_per_s=2.0,
        default_values_per_s=1.0, model_rank=0, ranking_agreement=1.0, probes=4))
    arrays, meta = plan.persist_artifacts()
    meta = dict(meta)
    meta["tuned_config"] = dict(meta["tuned_config"], tile=[8, 8, 8])
    back = SpGEMMPlan.from_artifacts(arrays, meta, device="cpu", a_vals=a.val, b_vals=b.val,
                                     a_pattern=a, b_pattern=b)
    assert back.tuned_config is None and back._stale_tuned is not None
    assert back.report.config_source == "stale-tuned"
    assert np.array_equal(back.execute().data, plan.execute().data)


def test_autotune_rejects_compact():
    a, b = _mats(9)
    with pytest.raises(ValueError, match="output='block'"):
        spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                    autotune=True, output="compact")


# -- tuned == untuned, bitwise -------------------------------------------------------------

def test_tuned_bitwise_equals_untuned_at_the_winner():
    a = suite_matrix("poisson3Da", scale=0.004).to_coo().sum_duplicates()
    rng = np.random.default_rng(17)
    v = rng.integers(-4, 5, a.nnz).astype(np.float32)
    a.val = np.where(v == 0, np.float32(1.0), v)
    b = COO(a.col, a.row, a.val, (a.shape[1], a.shape[0]))
    tuned = autotune_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                          model_top_k=2, probe_batch=2, repeats=1, depth_candidates=(1, 2))
    cfg = tuned.tuned_config
    ref = spgemm_plan(a, b, tile=cfg.tile, group=cfg.group, device="cpu", cache=PlanCache())
    av = rng.integers(-3, 4, a.nnz).astype(np.float32)
    bv = rng.integers(-3, 4, b.nnz).astype(np.float32)
    c_t = tuned.execute(av, bv)
    _same_csr(c_t, ref.execute(av, bv))
    avb = rng.integers(-3, 4, (5, a.nnz)).astype(np.float32)
    bvb = rng.integers(-3, 4, (5, b.nnz)).astype(np.float32)
    for x, y in zip(tuned.execute_batch(avb, bvb), ref.execute_batch(avb, bvb)):
        _same_csr(x, y)
    items = [(avb[i], bvb[i]) for i in range(5)]
    for x, (ai, bi) in zip(tuned.execute_stream(iter(items)), items):
        _same_csr(x, ref.execute(ai, bi))
    ap, bp = tuned.a_pattern, tuned.b_pattern
    ad = np.zeros(a.shape, np.float32)
    ad[ap.row, ap.col] = av
    bd = np.zeros(b.shape, np.float32)
    bd[bp.row, bp.col] = bv
    np.testing.assert_allclose(c_t.todense(), ad @ bd, rtol=1e-6, atol=1e-5)


def test_sharded_tuned_bitwise_equals_single():
    a, b = _mats(9, shape=(120, 90), density=0.08)
    mesh = make_shard_mesh(2, devices=["cpu", "cpu"])
    tuned = autotune_plan(
        a, b, tile=8, group=2, device="cpu", cache=PlanCache(), mesh=mesh,
        candidates=[((8, 8, 8), 2)], chunk_candidates=[None, 4096], depth_candidates=(2,),
        probe_batch=2, repeats=1, timer=FakeTimer([0.004, 0.001]),
    )
    assert tuned.n_shards == 2 and tuned.tuned_config.chunk_bytes == 4096
    assert tuned._executor._chunk_policy == resolve_chunk_bytes(4096, "cpu")
    single = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache())
    rng = np.random.default_rng(23)
    av = rng.integers(-3, 4, (3, a.nnz)).astype(np.float32)
    bv = rng.integers(-3, 4, (3, b.nnz)).astype(np.float32)
    _same_csr(tuned.execute(av[0], bv[0]), single.execute(av[0], bv[0]))
    for x, y in zip(tuned.execute_batch(av, bv), single.execute_batch(av, bv)):
        _same_csr(x, y)
    arrays, meta = tuned.persist_artifacts()
    assert meta["tuned_config"]["chunk_bytes"] == 4096 and meta["n_shards"] == 2


# -- the gateway takes the tuned config -------------------------------------------------------

def test_gateway_register_autotune_and_provenance():
    a, b = _mats(10)
    with SpGEMMGateway(cache=PlanCache(), depth=2) as gw:
        plan = gw.register("t0/l0", a, b, tile=16, group=2, device="cpu", autotune={
            "candidates": [((16, 16, 16), 2)], "chunk_candidates": [None],
            "depth_candidates": (4,), "probe_batch": 2, "repeats": 1,
            "timer": FakeTimer([0.001]),
        })
        assert plan.tuned_config is not None
        av, bv = np.asarray(a.val, np.float32), np.asarray(b.val, np.float32)
        res = gw.submit("t0/l0", av, bv).wait(60)
        ref = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache())
        _same_csr(res.value, ref.execute(av, bv))
        st = gw.stats()["patterns"]["t0/l0"]
        assert st["config_source"] == "tuned"
        assert st["tuned"] == plan.tuned_config.to_meta()
        assert st["pipeline_depth"] == 4  # the tuned depth beats the gateway's


def test_gateway_untuned_pattern_reports_default():
    a, b = _mats(11)
    gw = SpGEMMGateway(cache=PlanCache(), start=False, depth=2)
    gw.register("t1/l0", a, b, tile=16, group=2, device="cpu")
    st = gw.stats()["patterns"]["t1/l0"]
    assert (st["config_source"], st["tuned"], st["pipeline_depth"]) == ("default", None, 2)
    gw.close()


SECOND_PROCESS = """
import json, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.sparse.formats import COO
from repro_torch.sparse.random import suite_matrix
from repro_torch.spgemm import schedule_build_count, spgemm_plan
from repro_torch.spgemm.autotune import probe_run_count

assert os.environ["REPRO_TORCH_SPGEMM_PLAN_DIR"]
a = suite_matrix("poisson3Da", scale=0.004).to_coo().sum_duplicates()
v = np.random.default_rng(0).integers(-4, 5, a.nnz).astype(np.float32)
a.val = np.where(v == 0, np.float32(1.0), v)
b = COO(a.col, a.row, a.val, (a.shape[1], a.shape[0]))
plan = spgemm_plan(a, b, tile=16, group=2, device="cpu",
                   autotune={{"model_top_k": 2, "probe_batch": 2, "repeats": 1,
                              "depth_candidates": (2,)}})
cfg = plan.tuned_config
if {warm}:
    assert probe_run_count() == 0, "the warm process paid probes"
    assert plan.report.config_source == "persisted" and cfg.source == "persisted"
    assert plan.report.schedule_builds == 0
else:
    assert probe_run_count() == cfg.probes > 0
    assert plan.report.config_source == "tuned"
c = plan.execute()
print("CFG " + json.dumps(cfg.to_meta(), sort_keys=True))
print("C " + str(float(np.abs(c.data).sum())))
"""


def test_second_process_applies_the_persisted_config_with_zero_probes(tmp_path):
    """Process 1 searches and persists; process 2, a fresh plain Python
    interpreter on the same store, applies the same TunedConfig with its
    probe counter at zero, and computes the same C."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPRO_TORCH_SPGEMM_PLAN_DIR"] = str(tmp_path)
    outs = []
    for warm in (False, True):
        code = textwrap.dedent(SECOND_PROCESS.format(src=os.path.join(ROOT, "src"), warm=warm))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=300)
        assert out.returncode == 0, out.stderr[-4000:]
        outs.append(out.stdout)

    def get(out, tag):
        return [ln for ln in out.splitlines() if ln.startswith(tag + " ")][0]

    cold, warm = outs
    assert get(cold, "CFG").replace('"probed"', '"persisted"') == get(warm, "CFG")
    assert get(cold, "C") == get(warm, "C")
