"""Port parity: the disk tier of ``repro_torch``'s plan cache
(``spgemm/persist.py``'s :class:`PlanStore`) and warm restarts, on the
CPU, against the JAX package.

Three layers, as in ``tests/test_persist.py``:

* the codecs: the arrays a port plan persists (schedule, assembly map,
  compact map, scatter indices, shard bounds) equal the JAX package's for
  the same pattern bitwise, and round-trip bitwise;
* the :class:`PlanStore` file format is integrity checked: corrupted,
  version-bumped, tampered, cross-key files degrade to a miss, never to a
  wrong plan; writes fsync the payload and the directory; stale
  temporaries are collected; the byte budget evicts oldest first;
* warm restarts (a fresh :class:`PlanCache` on a populated directory, and
  a second Python process resolving a pattern token) skip the symbolic
  phase and give results bitwise equal to the cold plan's.

A port store and a JAX-package store sharing one directory never touch
each other's files: the port's entries, alias index and temporaries have
names of their own.
"""
import json
import os
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core.schedule import (  # noqa: E402
    partition_spgemm_schedule as r_partition_spgemm_schedule,
    shards_to_bounds as r_shards_to_bounds,
)
from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro.spgemm.persist import PlanStore as R_PlanStore  # noqa: E402
from repro_torch.core.schedule import (  # noqa: E402
    assembly_from_arrays,
    assembly_to_arrays,
    build_assembly_map,
    build_spgemm_schedule,
    partition_spgemm_schedule,
    schedule_from_arrays,
    schedule_to_arrays,
    shards_from_bounds,
    shards_to_bounds,
)
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo, to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.sparse.random import random_block_sparse  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    PlanCache,
    ShardedSpGEMMPlan,
    schedule_build_count,
    spgemm_plan,
)
from repro_torch.spgemm import persist  # noqa: E402
from repro_torch.spgemm.persist import PlanStore  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers side by side, and many threads per worker contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _int_coo(m, n, density, seed):
    """The same canonical COO for both packages, small-integer float32
    values: exact under any summation order, so warm-against-cold checks
    demand bitwise equality."""
    coo = r_random_coo(m, n, density, "uniform", seed=seed)
    rng = np.random.default_rng(seed + 999)
    vals = rng.integers(-4, 5, coo.nnz).astype(np.float32)
    coo.val = np.where(vals == 0, np.float32(1.0), vals)
    coo = coo.sum_duplicates()
    return COO(coo.row, coo.col, coo.val, coo.shape), coo


def _mats(seed=11, m=120, n=90):
    (a, ra) = _int_coo(m, n, 0.08, seed)
    b = COO(a.col, a.row, a.val, (n, m))
    rb = R_COO(a.col, a.row, a.val, (n, m))
    return a, b, ra, rb


def _schedule(seed=3, shape=(140, 100), tile=8, group=2):
    a, _ = _int_coo(shape[0], shape[1], 0.07, seed)
    b = COO(a.col, a.row, a.val, (shape[1], shape[0]))
    a_bcsv, _ = bcsv_from_coo(a, (tile, tile), group)
    b_bcsr, _ = bcsr_from_coo(b, (tile, tile))
    return build_spgemm_schedule(a_bcsv, b_bcsr)


def _assert_schedules_equal(s1, s2):
    for f in ("a_slot", "b_slot", "panel", "sub_row", "start",
              "panel_group", "panel_bcol", "c_brow", "c_bcol"):
        a1, a2 = getattr(s1, f), getattr(s2, f)
        assert a1.dtype == a2.dtype and np.array_equal(a1, a2), f
    for f in ("group", "grid_m", "grid_n", "grid_k"):
        assert getattr(s1, f) == getattr(s2, f), f


def _assert_arrays_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


# -- codecs -------------------------------------------------------------------

class TestCodecs:
    @pytest.mark.parametrize("output", ["block", "compact"])
    def test_persisted_arrays_equal_the_reference_bitwise(self, output):
        """Schedule, assembly, compact map and scatter indices: the arrays
        of the port's artifacts are the JAX package's, dtype for dtype."""
        a, b, ra, rb = _mats(5)
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                           output=output)
        ref = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=R_PlanCache(),
                            output=output)
        arrays, meta = plan.persist_artifacts()
        r_arrays, r_meta = ref.persist_artifacts()
        _assert_arrays_bitwise(arrays, r_arrays)
        assert meta["backend"] == "torch" and r_meta["backend"] == "jnp"
        assert {k: v for k, v in meta.items() if k != "backend"} == \
            {k: v for k, v in r_meta.items() if k != "backend"}

    @pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
    def test_shard_bounds_equal_the_reference_bitwise(self, n_shards):
        """A sharded plan's persisted bounds are the JAX package's
        partition of the same schedule."""
        a, b, ra, rb = _mats(7)
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                           mesh=make_shard_mesh(n_shards, devices=["cpu"] * n_shards))
        ref = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=R_PlanCache())
        arrays, meta = plan.persist_artifacts()
        want = r_shards_to_bounds(r_partition_spgemm_schedule(ref.schedule, n_shards))
        assert arrays["shard_bounds"].dtype == want.dtype
        assert np.array_equal(arrays["shard_bounds"], want)
        assert meta["n_shards"] == n_shards and meta["mesh_axis"] == "shard"

    def test_schedule_and_assembly_roundtrip_bitwise(self):
        sch = _schedule()
        _assert_schedules_equal(sch, schedule_from_arrays(schedule_to_arrays(sch)))
        asm = build_assembly_map(sch, (8, 8), (140, 140))
        back = assembly_from_arrays(assembly_to_arrays(asm))
        for f in ("gather", "indptr", "indices"):
            assert getattr(back, f).dtype == getattr(asm, f).dtype
            assert np.array_equal(getattr(back, f), getattr(asm, f))
        assert back.shape == asm.shape

    @pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
    def test_shard_bounds_roundtrip_bitwise(self, n_shards):
        """The group-bound vector alone rebuilds every shard slice."""
        sch = _schedule()
        shards = partition_spgemm_schedule(sch, n_shards)
        back = shards_from_bounds(sch, shards_to_bounds(shards))
        assert len(back) == len(shards)
        for s1, s2 in zip(shards, back):
            for f in ("group_lo", "group_hi", "triple_lo", "triple_hi",
                      "panel_lo", "panel_hi", "a_lo", "a_hi"):
                assert getattr(s1, f) == getattr(s2, f), f
            _assert_schedules_equal(s1.schedule, s2.schedule)

    def test_bad_bounds_raise(self):
        sch = _schedule()
        for bad in ([0, 3, 2], [1, 2], [0, 1]):
            with pytest.raises(ValueError):
                shards_from_bounds(sch, np.asarray(bad, np.int64))


# -- the store's file format ----------------------------------------------------

class TestPlanStore:
    KEY = ("pat", (8, 8, 8), 2, "torch", "cpu", None)

    def _arrays(self):
        return {"x": np.arange(7, dtype=np.int32),
                "y": np.linspace(0, 1, 5, dtype=np.float64)}

    def _rewrite(self, path, edit):
        with np.load(path, allow_pickle=False) as z:
            payload = {n: z[n] for n in z.files}
        edit(payload)
        with open(path, "wb") as f:
            np.savez(f, **payload)

    def test_save_load_roundtrip(self, tmp_path):
        store = PlanStore(str(tmp_path))
        meta = {"kind": "element", "group": 2}
        path = store.save(self.KEY, self._arrays(), meta)
        assert path is not None and path.endswith(".plan-torch.npz")
        arrays, got_meta = store.load(self.KEY)
        assert got_meta == meta
        _assert_arrays_bitwise(arrays, self._arrays())
        assert self.KEY in store and len(store) == 1

    def test_missing_is_none(self, tmp_path):
        assert PlanStore(str(tmp_path)).load(self.KEY) is None

    def test_corrupted_file_is_miss_and_removed(self, tmp_path):
        store = PlanStore(str(tmp_path))
        store.save(self.KEY, self._arrays(), {})
        path = store.path_for(self.KEY)
        with open(path, "r+b") as f:
            f.seek(30)
            f.write(b"\xde\xad\xbe\xef" * 8)
        assert store.load(self.KEY) is None
        assert not os.path.exists(path), "a corrupt file is dropped"

    def test_version_bump_is_miss(self, tmp_path, monkeypatch):
        store = PlanStore(str(tmp_path))
        store.save(self.KEY, self._arrays(), {})
        monkeypatch.setattr(persist, "FORMAT_VERSION", persist.FORMAT_VERSION + 1)
        assert store.load(self.KEY) is None

    def test_wrong_digest_is_miss(self, tmp_path):
        store = PlanStore(str(tmp_path))
        store.save(self.KEY, self._arrays(), {})

        def tamper(p):
            p["x"] = p["x"] + 1  # header digest kept

        self._rewrite(store.path_for(self.KEY), tamper)
        assert store.load(self.KEY) is None

    def test_tampered_meta_is_miss(self, tmp_path):
        store = PlanStore(str(tmp_path))
        store.save(self.KEY, self._arrays(), {"group": 2})

        def tamper(p):
            header = json.loads(bytes(np.asarray(p["__meta__"])).decode())
            header["meta"]["group"] = 4  # digest left untouched
            p["__meta__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)

        self._rewrite(store.path_for(self.KEY), tamper)
        assert store.load(self.KEY) is None

    def test_cross_key_file_is_miss(self, tmp_path):
        store = PlanStore(str(tmp_path))
        other = ("other-pattern",) + self.KEY[1:]
        store.save(self.KEY, self._arrays(), {})
        os.replace(store.path_for(self.KEY), store.path_for(other))
        assert store.load(other) is None

    def test_stale_tmp_files_are_collected(self, tmp_path):
        stray = tmp_path / (persist.plan_file_name(self.KEY) + ".123.4.tmp-torch")
        stray.write_bytes(b"half-written")
        old = os.path.getmtime(str(stray)) - 7200
        os.utime(str(stray), (old, old))
        PlanStore(str(tmp_path))
        assert not stray.exists()
        stray.write_bytes(b"in-flight")  # a fresh one is another writer's
        store = PlanStore(str(tmp_path))
        assert stray.exists()
        store.clear()
        assert not stray.exists()

    def test_byte_budget_evicts_oldest(self, tmp_path):
        store = PlanStore(str(tmp_path))
        store.save(("k1",), self._arrays(), {})
        store.max_bytes = int(store.total_bytes() * 2.5)  # room for two
        store.load(("k1",))
        store.save(("k2",), self._arrays(), {})
        store.save(("k3",), self._arrays(), {})
        assert store.evictions >= 1
        assert store.total_bytes() <= store.max_bytes
        assert ("k3",) in store, "the file just written survives"

    def test_equal_mtime_order_is_name_deterministic(self, tmp_path):
        store = PlanStore(str(tmp_path))
        for k in (("ka",), ("kb",), ("kc",), ("kd",)):
            store.save(k, {"x": np.arange(16, dtype=np.int32)}, {})
        t = os.path.getmtime(store.files()[0])
        for p in store.files():
            os.utime(p, (t, t))
        got = store.files()
        assert got == sorted(got)
        store.max_bytes = store.total_bytes() - 1
        store._evict()
        assert store.evictions == 1 and store.files() == got[1:]

    @pytest.mark.parametrize("what", ["save", "alias"])
    def test_writes_fsync_payload_and_directory(self, tmp_path, monkeypatch, what):
        store = PlanStore(str(tmp_path))
        real_fsync, synced = os.fsync, []

        def recording_fsync(fd):
            synced.append(os.fstat(fd).st_mode)
            return real_fsync(fd)

        monkeypatch.setattr(os, "fsync", recording_fsync)
        if what == "save":
            assert store.save(self.KEY, {"x": np.arange(3, dtype=np.int32)}, {})
        else:
            assert store.alias_put("('tok',)", "('key',)")
        assert any(stat.S_ISREG(m) for m in synced), "payload not fsynced"
        assert any(stat.S_ISDIR(m) for m in synced), "directory not fsynced"

    def test_failed_save_leaves_no_tmp(self, tmp_path, monkeypatch):
        store = PlanStore(str(tmp_path))
        monkeypatch.setattr(os, "replace", lambda *a: (_ for _ in ()).throw(OSError("no")))
        assert store.save(self.KEY, {"x": np.arange(3, dtype=np.int32)}, {}) is None
        assert os.listdir(str(tmp_path)) == []

    def test_alias_index(self, tmp_path):
        """Roundtrip across instances, last writer wins, a missing target
        or a corrupt or version-bumped index is a miss, clear drops it."""
        store = PlanStore(str(tmp_path))
        arrays = {"x": np.arange(4, dtype=np.int32)}
        store.save(("full", "key"), arrays, {})
        store.save(("full", "key2"), arrays, {})
        assert store.alias_get("('t', 'x')") is None
        assert store.alias_put("('t', 'x')", "('full', 'key')")
        assert store.alias_put("('t', 'x')", "('full', 'key2')")
        assert PlanStore(str(tmp_path)).alias_get("('t', 'x')") == "('full', 'key2')"
        store.alias_put("('t', 'y')", "('full', 'never-saved')")
        assert store.alias_get("('t', 'y')") is None
        assert store.audit()["orphaned"] == ["('t', 'y')"]
        assert store.alias_get("('t', 'x')") == "('full', 'key2')"
        with open(store.alias_path(), "w", encoding="utf-8") as f:
            f.write("{this is not json")
        assert store.alias_get("('t', 'x')") is None
        assert store.alias_put("('t', 'x')", "('full', 'key')")
        with open(store.alias_path(), encoding="utf-8") as f:
            doc = json.load(f)
        doc["format_version"] = persist.FORMAT_VERSION + 1
        with open(store.alias_path(), "w", encoding="utf-8") as f:
            json.dump(doc, f)
        assert store.alias_get("('t', 'x')") is None
        store.clear()
        assert not os.path.exists(store.alias_path())


def test_port_and_reference_stores_share_a_directory(tmp_path):
    """Both packages' stores in one directory, each with a byte budget
    that evicts and an alias index: neither lists, loads, evicts,
    collects or overwrites the other's files."""
    d = str(tmp_path)
    a, b, ra, rb = _mats(13)
    r_cache = R_PlanCache(disk_dir=d)
    r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp", cache=r_cache, pattern_token="tok")
    r_files = sorted(os.listdir(d))
    r_bytes = {n: (tmp_path / n).read_bytes() for n in r_files}
    cache = PlanCache(disk_dir=d, disk_max_bytes=1)  # evicts all but the newest
    for seed in (13, 14):
        a_s, b_s, _, _ = _mats(seed)
        spgemm_plan(a_s, b_s, tile=8, group=2, device="cpu", cache=cache,
                    pattern_token="tok" if seed == 13 else None)
    assert cache.store.evictions >= 1
    stray = tmp_path / "x.plan.npz.1.2.tmp"  # a reference writer's temporary
    stray.write_bytes(b"in-flight")
    cache.store.clear()
    assert stray.exists()
    stray.unlink()
    assert sorted(os.listdir(d)) == r_files
    assert all((tmp_path / n).read_bytes() == r_bytes[n] for n in r_files)
    # ...and the other way round: the reference store leaves the port's
    # entry, alias index and temporaries alone.
    spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(disk_dir=d),
                pattern_token="tok")
    port_files = sorted(n for n in os.listdir(d) if n not in r_bytes)
    assert any(n.endswith(".plan-torch.npz") for n in port_files)
    assert "torch-tokens.index.json" in port_files
    fresh_tmp = tmp_path / "y.plan-torch.npz.1.2.tmp-torch"
    fresh_tmp.write_bytes(b"in-flight")
    port_bytes = {n: (tmp_path / n).read_bytes() for n in port_files}
    r_store = R_PlanStore(d, max_bytes=1)
    r_store._evict()
    r_store.clear()
    assert fresh_tmp.exists()
    assert all((tmp_path / n).read_bytes() == port_bytes[n] for n in port_files)
    warm = PlanCache(disk_dir=d)
    p = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=warm, pattern_token="tok")
    assert warm.stats.token_disk_hits == 1 and p.report.schedule_builds == 0


# -- warm restarts ----------------------------------------------------------------

class TestWarmRestart:
    def test_element_warm_start_bitwise(self, tmp_path):
        a, b, _, _ = _mats()
        cold_cache = PlanCache(disk_dir=str(tmp_path))
        cold = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cold_cache)
        c_cold = cold.execute()
        assert cold.report.schedule_builds == 1 and cold.report.loads == 0
        assert cold_cache.stats.stores == 1
        builds = schedule_build_count()
        warm_cache = PlanCache(disk_dir=str(tmp_path))
        warm = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=warm_cache)
        assert warm is not cold and schedule_build_count() == builds
        assert warm.report.schedule_builds == 0
        assert warm.report.loads == 1 and warm.report.load_hits == 1
        assert warm_cache.stats.disk_hits == 1
        c_warm = warm.execute()
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(c_cold, f), getattr(c_warm, f)), f
        av = warm.a_pattern.val * 2.0
        bv = warm.b_pattern.val * 3.0
        assert np.array_equal(cold.execute(av, bv).data, warm.execute(av, bv).data)
        rng = np.random.default_rng(5)
        av = rng.integers(-3, 4, (4, a.nnz)).astype(np.float32)
        bv = rng.integers(-3, 4, (4, b.nnz)).astype(np.float32)
        for c1, c2 in zip(cold.execute_batch(av, bv), warm.execute_batch(av, bv)):
            assert np.array_equal(c1.data, c2.data)

    def test_block_warm_start_bitwise(self, tmp_path):
        ad = random_block_sparse(96, 96, (16, 16), 0.4, seed=31)
        bd = random_block_sparse(96, 96, (16, 16), 0.4, seed=32)
        ab, bb = to_bcsv(ad, (16, 16), 2), to_bcsr(bd, (16, 16))
        cold = spgemm_plan(ab, bb, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
        warm = spgemm_plan(ab, bb, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
        assert warm.report.schedule_builds == 0 and warm.report.load_hits == 1
        assert np.array_equal(cold.execute().data, warm.execute().data)
        assert warm.report.nnz_a == cold.report.nnz_a

    @pytest.mark.parametrize("n_shards", [1, 4])
    def test_sharded_warm_start(self, tmp_path, n_shards):
        a, b, _, _ = _mats(41)
        mesh = make_shard_mesh(n_shards, devices=["cpu"] * n_shards)
        cold = spgemm_plan(a, b, tile=8, group=2, device="cpu", mesh=mesh,
                           cache=PlanCache(disk_dir=str(tmp_path)))
        warm = spgemm_plan(a, b, tile=8, group=2, device="cpu", mesh=mesh,
                           cache=PlanCache(disk_dir=str(tmp_path)))
        assert isinstance(warm, ShardedSpGEMMPlan)
        assert warm.report.schedule_builds == 0
        assert warm.shard_stats() == cold.shard_stats()
        assert np.array_equal(cold.execute().data, warm.execute().data)

    def test_corrupt_entry_falls_back_to_build(self, tmp_path):
        a, b, _, _ = _mats(51)
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
        (path,) = PlanStore(str(tmp_path)).files()
        with open(path, "r+b") as f:
            f.seek(40)
            f.write(b"garbage!" * 16)
        cache = PlanCache(disk_dir=str(tmp_path))
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache)
        assert plan.report.schedule_builds == 1 and plan.report.loads == 0
        assert cache.stats.disk_misses == 1 and cache.stats.stores == 1
        warm = spgemm_plan(a, b, tile=8, group=2, device="cpu",
                           cache=PlanCache(disk_dir=str(tmp_path)))
        assert warm.report.schedule_builds == 0

    def test_loader_rejection_falls_back_to_build(self, tmp_path):
        """A verified file whose content the rehydrator rejects (a future
        plan kind) rebuilds."""
        a, b, _, _ = _mats(61)
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
        path = PlanStore(str(tmp_path)).files()[0]
        with np.load(path, allow_pickle=False) as z:
            payload = {n: z[n] for n in z.files}
        header = json.loads(bytes(np.asarray(payload["__meta__"])).decode())
        header["meta"]["kind"] = "from-the-future"
        arrays = {n: v for n, v in payload.items() if n != "__meta__"}
        header["digest"] = persist._payload_digest(arrays, header["meta"])
        payload["__meta__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
        with open(path, "wb") as f:
            np.savez(f, **payload)
        cache = PlanCache(disk_dir=str(tmp_path))
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache)
        assert plan.report.schedule_builds == 1 and cache.stats.load_failures == 1

    def test_memory_tier_wins_and_no_disk_dir_keeps_memory_only(self, tmp_path):
        a, b, _, _ = _mats(71)
        cache = PlanCache(disk_dir=str(tmp_path))
        p1 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache)
        assert spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache) is p1
        assert cache.stats.hits == 1 and cache.stats.disk_hits == 0
        mem = PlanCache()
        assert mem.store is None
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=mem)
        s = mem.stats()
        assert s["disk_hits"] == 0 and s["stores"] == 0 and "disk_files" not in s


class TestTokenDiskRestart:
    def test_token_lookup_skips_digest_on_restart(self, tmp_path, monkeypatch):
        a, b, _, _ = _mats(61, 96, 80)
        c1 = PlanCache(disk_dir=str(tmp_path))
        p1 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c1, pattern_token="svc/l0")
        want = p1.execute()
        import repro_torch.spgemm.plan as plan_mod

        def boom(*_a, **_k):
            raise AssertionError("pattern digest computed on the token path")

        monkeypatch.setattr(plan_mod, "pattern_digest", boom)
        c2 = PlanCache(disk_dir=str(tmp_path))
        p2 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c2, pattern_token="svc/l0")
        assert c2.stats.token_disk_hits == 1
        assert c2.stats.disk_hits == 1 and c2.stats.load_failures == 0
        assert p2.report.schedule_builds == 0 and p2.report.pattern_token == "svc/l0"
        got = p2.execute()
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c2,
                           pattern_token="svc/l0") is p2
        assert c2.stats.token_disk_hits == 1

    def test_missing_or_stale_alias_falls_back(self, tmp_path):
        a, b, _, _ = _mats(62, 96, 80)
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
                    pattern_token="svc/l1")
        os.unlink(PlanStore(str(tmp_path)).alias_path())
        c2 = PlanCache(disk_dir=str(tmp_path))
        p2 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c2, pattern_token="svc/l1")
        assert c2.stats.token_disk_hits == 0 and c2.stats.disk_hits == 1
        assert p2.report.schedule_builds == 0
        for p in PlanStore(str(tmp_path)).files():
            os.unlink(p)  # artifacts gone, the alias c2 rebound survives
        c3 = PlanCache(disk_dir=str(tmp_path))
        p3 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c3, pattern_token="svc/l1")
        assert p3.report.schedule_builds == 1 and c3.stats.token_disk_hits == 0

    def test_token_restart_refuses_another_value_dtype(self, tmp_path):
        """The alias is a pointer, not trusted content: float64 operands
        do not rehydrate a float32 plan through it."""
        a, b, _, _ = _mats(63, 96, 80)
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
                    pattern_token="tok")
        a64 = COO(a.row, a.col, a.val.astype(np.float64), a.shape)
        b64 = COO(b.row, b.col, b.val.astype(np.float64), b.shape)
        c2 = PlanCache(disk_dir=str(tmp_path))
        p64 = spgemm_plan(a64, b64, tile=8, group=2, device="cpu", cache=c2,
                          pattern_token="tok")
        assert c2.stats.load_failures == 1 and c2.stats.token_disk_hits == 0
        assert p64.report.schedule_builds == 1  # the digest path built it


SECOND_PROCESS = """
import hashlib, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.sparse.formats import COO
from repro_torch.spgemm import default_cache, schedule_build_count, spgemm_plan
d = np.load({ops!r})
a = COO(d["row"], d["col"], d["val"], tuple(d["shape"]))
b = COO(d["col"], d["row"], d["val"], tuple(d["shape"][::-1]))
plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", pattern_token="svc/poisson")
s = default_cache().stats()
assert s["token_disk_hits"] == 1 and s["disk_hits"] == 1, s
assert schedule_build_count() == 0 and plan.report.schedule_builds == 0
c = plan.execute(d["av"], d["bv"])
print("DIGEST", hashlib.blake2b(c.data.tobytes() + c.indices.tobytes()).hexdigest())
"""


def test_second_process_resolves_token_from_disk(tmp_path):
    """A genuinely fresh interpreter with the disk tier set through the
    environment resolves the token through the alias index, builds no
    schedule, and executes bitwise equal to the first process."""
    import hashlib

    a, b, _, _ = _mats(81, 96, 80)
    rng = np.random.default_rng(3)
    av = rng.standard_normal(a.nnz).astype(np.float32)
    bv = rng.standard_normal(b.nnz).astype(np.float32)
    plans = tmp_path / "plans"
    cache = PlanCache(disk_dir=str(plans))
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache,
                       pattern_token="svc/poisson")
    c = plan.execute(av, bv)
    ops = tmp_path / "ops.npz"
    np.savez(ops, row=a.row, col=a.col, val=a.val, shape=np.asarray(a.shape), av=av, bv=bv)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env[persist.PLAN_DIR_ENV] = str(plans)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(SECOND_PROCESS.format(
            src=os.path.join(ROOT, "src"), ops=str(ops)))],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = hashlib.blake2b(c.data.tobytes() + c.indices.tobytes()).hexdigest()
    assert f"DIGEST {want}" in out.stdout


# -- compact and chained plans (the port's counterparts of tests/test_chain.py) ----

def test_persist_rehydrate_roundtrip(tmp_path):
    a, b, _, _ = _mats(7, 96, 80)
    p1 = spgemm_plan(a, b, tile=8, group=2, device="cpu", output="compact",
                     cache=PlanCache(disk_dir=str(tmp_path)))
    r1 = p1.execute()
    c2 = PlanCache(disk_dir=str(tmp_path))
    p2 = spgemm_plan(a, b, tile=8, group=2, device="cpu", output="compact", cache=c2)
    assert c2.stats.loads == 1
    assert p2.output == "compact" and p2.compact is not None
    for f in ("gather", "indptr", "indices"):
        assert np.array_equal(getattr(p1.compact, f), getattr(p2.compact, f))
    assert np.array_equal(r1.data, p2.execute().data)


def test_block_and_compact_keys_are_distinct(tmp_path):
    a, b, _, _ = _mats(8, 96, 80)
    cache = PlanCache(disk_dir=str(tmp_path))
    p_blk = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache)
    p_cmp = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache, output="compact")
    assert p_blk is not p_cmp and cache.stats.misses == 2
    assert spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache,
                       output="compact") is p_cmp
    assert len(cache.store) == 2


def test_chained_plan_persists(tmp_path):
    (a, _), (b, _), (c, _) = (_int_coo(64, 56, 0.07, 48), _int_coo(56, 48, 0.07, 49),
                              _int_coo(48, 40, 0.07, 50))
    c1 = PlanCache(disk_dir=str(tmp_path))
    out1 = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c1,
                       output="compact").then(c, cache=c1).execute()
    builds = schedule_build_count()
    c2 = PlanCache(disk_dir=str(tmp_path))
    chain = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=c2,
                        output="compact").then(c, cache=c2)
    assert c2.stats.loads == 2 and schedule_build_count() == builds
    assert np.array_equal(out1.data, chain.execute().data)
