"""Port parity: ``repro_torch.analysis`` (the static plan verifier, the
K1/K2 launch lint, ``validate="deep"``) on the CPU, against
``repro.analysis``.

Mirrors ``tests/test_verify.py`` (and the compact-map faults of
``tests/test_chain.py``): pristine element, block, sharded (1, 2 and 4
shards on ``cpu``), tuned, compact and rehydrated plans verify clean, and
``verify_plan``'s ``checks_run`` and finding names equal the reference's
on the same operands; each schedule, assembly, shard and compact fault is
caught under the reference's check name (the port's and the reference's
check functions run on the same mutation, and their error sets must be
equal); a corrupted-but-digest-valid artifact is rejected inside the
loader under ``validate="deep"`` and rebuilt without the numeric phase
ever running on it, and loads without it; the store audit. Port-only: the
launch half of the race proof over the staged schedule runs, and the
launch lint's faults (an ``a_slot`` past its batch element, a tile dim of
24, ``bsz`` 65536, shared memory over the limit).
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
from _compat_hypothesis import given, settings, st

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.analysis import verify as r_verify  # noqa: E402
from repro.sparse.convert import to_bcsr as r_to_bcsr, to_bcsv as r_to_bcsv  # noqa: E402
from repro.sparse.random import random_block_sparse as r_random_block_sparse  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.analysis import kernel_lint  # noqa: E402
from repro_torch.analysis.kernel_lint import (  # noqa: E402
    k1_smem_bytes,
    lint_kernel_module,
    lint_plan_kernel_specs,
)
from repro_torch.analysis.verify import (  # noqa: E402
    PlanVerificationError,
    check_assembly,
    check_batch_races,
    check_schedule,
    check_shard_partition,
    verify_plan,
)
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    PlanCache,
    TunedConfig,
    plan_from_structural_pattern,
    spgemm_plan,
)
from repro_torch.spgemm import executor as executor_mod  # noqa: E402


def _coo_pair(r):
    """The reference COO ``r`` and the same arrays as a port COO."""
    return COO(r.row, r.col, r.val, r.shape), r


def _mats(seed=0, m=96, n=80, k=72, density=0.06, integer=False):
    """(port (a, b), reference (a, b)) on the same arrays."""
    ra = r_random_coo(m, k, density, "uniform", seed=seed).sum_duplicates()
    rb = r_random_coo(k, n, density, "uniform", seed=seed + 1).sum_duplicates()
    if integer:
        for i, r in enumerate((ra, rb)):
            vals = np.random.default_rng(seed + 999 + i).integers(-4, 5, r.nnz)
            r.val = np.where(vals == 0, 1, vals).astype(np.float32)
    (a, _), (b, _) = _coo_pair(ra), _coo_pair(rb)
    return (a, b), (ra, rb)


def _element_plans(seed=0, tile=8, group=2, **kw):
    """A port element plan on the CPU and the reference's (``jnp``) on the
    same operands."""
    (a, b), (ra, rb) = _mats(seed)
    return (spgemm_plan(a, b, tile=tile, group=group, device="cpu", cache=PlanCache(), **kw),
            r_spgemm_plan(ra, rb, tile=tile, group=group, backend="jnp", cache=R_PlanCache(),
                          **kw))


def _block_plans(**kw):
    ad = r_random_block_sparse(128, 128, (32, 32), 0.3, seed=3)
    bd = r_random_block_sparse(128, 128, (32, 32), 0.3, seed=4)
    return (spgemm_plan(to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32)), device="cpu",
                        cache=PlanCache(), **kw),
            r_spgemm_plan(r_to_bcsv(ad, (32, 32), 2), r_to_bcsr(bd, (32, 32)), backend="jnp",
                          cache=R_PlanCache(), **kw))


def _checks(findings):
    return {f.check for f in findings if f.severity == "error"}


def _same_report(rep, ref):
    """The port's report says what the reference's says: checks run,
    plan kind, sharding, and the finding names."""
    assert rep.checks_run == ref.checks_run
    assert set(rep.check_seconds) == set(rep.checks_run)
    assert (rep.plan_kind, rep.sharded, rep.ok) == (ref.plan_kind, ref.sharded, ref.ok)
    assert sorted((f.check, f.severity) for f in rep.findings) == sorted(
        (f.check, f.severity) for f in ref.findings)


class TestPristinePlansVerifyClean:
    def test_element_plan(self):
        plan, ref = _element_plans()
        rep = verify_plan(plan)
        assert rep.ok, rep.summary()
        assert rep.plan_kind == "element" and not rep.sharded
        _same_report(rep, r_verify.verify_plan(ref))
        # Tile 8 runs on the CPU only: the launch lint says why.
        assert _checks(lint_plan_kernel_specs(plan)) == {"kernel.tile-dims"}

    def test_block_plan(self):
        plan, ref = _block_plans()
        rep = verify_plan(plan)
        assert rep.ok, rep.summary()
        assert rep.plan_kind == "block"
        _same_report(rep, r_verify.verify_plan(ref))
        assert lint_plan_kernel_specs(plan) == []

    def test_sharded_plan_single_device(self):
        (a, b), (ra, rb) = _mats(2, m=128)
        from repro.launch.mesh import make_shard_mesh as r_make_shard_mesh

        plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                           mesh=make_shard_mesh(1, devices=["cpu"]))
        ref = r_spgemm_plan(ra, rb, tile=16, group=2, backend="jnp", cache=R_PlanCache(),
                            mesh=r_make_shard_mesh(1))
        rep = verify_plan(plan)
        assert rep.ok, rep.summary()
        assert rep.sharded
        _same_report(rep, r_verify.verify_plan(ref))
        assert lint_plan_kernel_specs(plan) == []

    @pytest.mark.parametrize("shards", [2, 4])
    def test_sharded_plans_on_cpu(self, forced_devices, shards):
        """The reference needs a device per shard (forced host devices, in
        a subprocess); the port's shards all sit on ``cpu``."""
        out = forced_devices(f"""
import json
from repro.analysis.verify import verify_plan
from repro.launch.mesh import make_shard_mesh
from repro.sparse.random import random_coo
from repro.spgemm import PlanCache, spgemm_plan

a = random_coo(160, 96, 0.05, "uniform", seed=0).sum_duplicates()
b = random_coo(96, 112, 0.05, "uniform", seed=1).sum_duplicates()
plan = spgemm_plan(a, b, tile=16, group=2, backend="jnp", cache=PlanCache(),
                   mesh=make_shard_mesh({shards}), validate="deep")
rep = verify_plan(plan)
print("REPORT", json.dumps({{"checks": rep.checks_run, "kind": rep.plan_kind,
                            "sharded": rep.sharded,
                            "findings": sorted(f.check for f in rep.findings)}}))
""", devices=shards)
        want = json.loads(out.split("REPORT", 1)[1])
        ra = r_random_coo(160, 96, 0.05, "uniform", seed=0).sum_duplicates()
        rb = r_random_coo(96, 112, 0.05, "uniform", seed=1).sum_duplicates()
        (a, _), (b, _) = _coo_pair(ra), _coo_pair(rb)
        plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                           mesh=make_shard_mesh(shards, devices=["cpu"] * shards),
                           validate="deep")
        rep = verify_plan(plan)
        assert rep.ok, rep.summary()
        assert rep.sharded and plan.n_shards == shards
        assert rep.checks_run == want["checks"] and rep.plan_kind == want["kind"]
        assert rep.sharded == want["sharded"]
        assert sorted(f.check for f in rep.findings) == want["findings"]
        assert lint_plan_kernel_specs(plan) == []

    @pytest.mark.parametrize("stale", [False, True])
    def test_tuned_plan(self, stale):
        from repro.spgemm.autotune import TunedConfig as R_TunedConfig

        plan, ref = _element_plans()
        kw = dict(tile=(16, 16, 16) if stale else (8, 8, 8), group=2, chunk_bytes=55555,
                  pipeline_depth=3, values_per_s=10.0, default_values_per_s=9.0,
                  model_rank=0, ranking_agreement=1.0, probes=6)
        plan.apply_tuned_config(TunedConfig(**kw))
        ref.apply_tuned_config(R_TunedConfig(**kw))
        rep = verify_plan(plan)
        assert rep.ok, rep.summary()
        _same_report(rep, r_verify.verify_plan(ref))
        assert [f.check for f in rep.findings] == (["tuned.stale-config"] if stale else [])

    @pytest.mark.parametrize("stale", [False, True])
    def test_deep_report_is_kept_until_the_plan_is_tuned(self, stale):
        """``validate="deep"`` keeps its accepting report, with the time of
        each check it ran; tuning the plan clears it, and a fresh
        ``verify_plan`` sees the tuned state."""
        (a, b), _ = _mats(11)
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                           validate="deep")
        rep = plan.report.verify_report
        assert rep is not None and rep.ok and "tuned" not in rep.checks_run
        assert set(rep.check_seconds) == set(rep.checks_run)
        assert all(v >= 0.0 for v in rep.check_seconds.values())
        plan.apply_tuned_config(TunedConfig(
            tile=(16, 16, 16) if stale else (8, 8, 8), group=2, chunk_bytes=55555,
            pipeline_depth=3, values_per_s=10.0, default_values_per_s=9.0, model_rank=0,
            ranking_agreement=1.0, probes=6))
        assert plan.report.verify_report is None
        assert ("tuned" in verify_plan(plan).checks_run) == stale

    def test_compact_plan(self):
        plan, ref = _element_plans(output="compact")
        rep = verify_plan(plan)
        assert rep.ok and "compact" in rep.checks_run, rep.summary()
        _same_report(rep, r_verify.verify_plan(ref))

    def test_rehydrated_plan(self, tmp_path):
        (a, b), (ra, rb) = _mats(7)
        spgemm_plan(a, b, tile=8, group=2, device="cpu",
                    cache=PlanCache(disk_dir=str(tmp_path / "port")))
        warm = spgemm_plan(a, b, tile=8, group=2, device="cpu",
                           cache=PlanCache(disk_dir=str(tmp_path / "port")), validate="deep")
        r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp",
                      cache=R_PlanCache(disk_dir=str(tmp_path / "ref")))
        r_warm = r_spgemm_plan(ra, rb, tile=8, group=2, backend="jnp",
                               cache=R_PlanCache(disk_dir=str(tmp_path / "ref")))
        assert warm.report.load_hits >= 1 and warm.report.schedule_builds == 0
        rep = verify_plan(warm)
        assert rep.ok
        _same_report(rep, r_verify.verify_plan(r_warm))

    def test_kernel_module_lint_clean(self):
        assert lint_kernel_module() == []

    def test_deep_validate_all_return_paths(self, tmp_path):
        (a, b), _ = _mats(9)
        cache = PlanCache(disk_dir=str(tmp_path))
        kw = dict(tile=8, group=2, device="cpu", validate="deep")
        fresh = spgemm_plan(a, b, cache=cache, pattern_token="t/deep", **kw)
        hit = spgemm_plan(a, b, cache=cache, pattern_token="t/deep", **kw)
        assert hit is fresh
        # A restarted worker: the token resolves through the store's alias
        # index to a disk load, verified inside the loader.
        warm = spgemm_plan(a, b, cache=PlanCache(disk_dir=str(tmp_path)),
                           pattern_token="t/deep", **kw)
        assert warm.report.loads == 1 and warm.report.schedule_builds == 0
        blk, _ = _block_plans(validate="deep")
        assert blk.schedule.num_triples > 0
        with pytest.raises(ValueError, match="validate"):
            spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                        validate="shallow")

    def test_deep_validate_structural_pattern(self, tmp_path):
        (a, b), _ = _mats(10)
        first = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(),
                            output="compact")
        c = COO(b.col, b.row, b.val, (b.shape[1], b.shape[0]))
        kw = dict(tile=8, group=2, device="cpu", output="compact", validate="deep")
        cold = plan_from_structural_pattern(first.output_pattern(), c,
                                            cache=PlanCache(disk_dir=str(tmp_path)), **kw)
        warm = plan_from_structural_pattern(first.output_pattern(), c,
                                            cache=PlanCache(disk_dir=str(tmp_path)), **kw)
        assert warm.report.loads == 1 and verify_plan(cold).ok
        with pytest.raises(ValueError, match="validate"):
            plan_from_structural_pattern(first.output_pattern(), c, tile=8, group=2,
                                         device="cpu", cache=PlanCache(), validate="yes")


class TestScheduleFaultInjection:
    """Each mutation class is detected by its check family, under the
    reference's check names: both packages' ``check_schedule`` run on the
    same mutation of their (bitwise equal) schedules."""

    def _run(self, plans, mutate):
        got = []
        for plan, check in zip(plans, (check_schedule, r_verify.check_schedule)):
            findings = []
            s = plan.schedule
            check(dataclasses.replace(s, **mutate(s)), int(plan._a_shape[0]),
                  int(plan._b_shape[0]), findings)
            got.append(_checks(findings))
        assert got[0] == got[1], got
        return got[0]

    @given(pos=st.integers(min_value=0, max_value=10 ** 9))
    @settings(max_examples=12, deadline=None)
    def test_out_of_bounds_a_slot(self, pos):
        plans = _element_plans()
        na = int(plans[0]._a_shape[0])

        def mutate(s):
            a_slot = s.a_slot.copy()
            a_slot[pos % len(a_slot)] = na  # one past the last real block
            return {"a_slot": a_slot}

        assert "schedule.a-slot-bounds" in self._run(plans, mutate)

    @given(pos=st.integers(min_value=0, max_value=10 ** 9))
    @settings(max_examples=12, deadline=None)
    def test_out_of_bounds_panel(self, pos):
        def mutate(s):
            panel = s.panel.copy()
            panel[pos % len(panel)] = s.n_panels  # the write-only dummy slot
            return {"panel": panel}

        assert "schedule.panel-bounds" in self._run(_element_plans(), mutate)

    @given(pos=st.integers(min_value=1, max_value=10 ** 9))
    @settings(max_examples=12, deadline=None)
    def test_start_flag_corruption(self, pos):
        def mutate(s):
            start = s.start.copy()
            i = pos % len(start)
            start[i] = 1 - start[i]
            return {"start": start}

        assert "schedule.start-flags" in self._run(_element_plans(), mutate)

    def test_split_panel_run(self):
        plans = _element_plans()
        s = plans[0].schedule
        assert s.num_triples >= 3 and s.n_panels >= 2

        def mutate(s):
            panel, start = s.panel.copy(), s.start.copy()
            panel[-1] = panel[0]
            start[-1] = 1
            return {"panel": panel, "start": start}

        got = self._run(plans, mutate)
        assert "schedule.panel-contiguity" in got or "schedule.panel-coverage" in got

    def test_unsorted_panel_keys(self):
        def mutate(s):
            pg, pb = s.panel_group.copy(), s.panel_bcol.copy()
            pg[[0, -1]] = pg[[-1, 0]]
            pb[[0, -1]] = pb[[-1, 0]]
            return {"panel_group": pg, "panel_bcol": pb}

        assert "schedule.panel-order" in self._run(_element_plans(), mutate)


class TestAssemblyFaultInjection:
    def _run(self, **fields):
        got = []
        for plan, check in zip(_element_plans(), (check_assembly, r_verify.check_assembly)):
            asm = plan.assembly
            repl = {k: fn(np.asarray(getattr(asm, k)).copy(), plan) for k, fn in fields.items()}
            findings = []
            check(plan.schedule, dataclasses.replace(asm, **repl), (plan._bm, plan._bn),
                  findings)
            got.append(_checks(findings))
        assert got[0] == got[1], got
        return got[0]

    @given(pos=st.integers(min_value=0, max_value=10 ** 9))
    @settings(max_examples=12, deadline=None)
    def test_duplicated_gather_index(self, pos):
        def dup(g, plan):
            i = pos % (len(g) - 1)
            g[i] = g[i + 1]
            return g

        assert "assembly.gather-duplicate" in self._run(gather=dup)

    @given(pos=st.integers(min_value=0, max_value=10 ** 9))
    @settings(max_examples=12, deadline=None)
    def test_pad_panel_read(self, pos):
        def pad(g, plan):
            s = plan.schedule
            span = s.group * plan._bm * plan._bn
            g[pos % len(g)] = s.n_panels * span + pos % span
            return g

        assert "assembly.pad-panel-read" in self._run(gather=pad)

    def test_indptr_corruption(self):
        def bump(indptr, plan):
            indptr[len(indptr) // 2] += 1
            return indptr

        assert self._run(indptr=bump) & {"assembly.indptr-monotone", "assembly.indptr-total",
                                         "assembly.column-order"}

    def test_unsorted_columns(self):
        def swap(indices, plan):
            indptr = np.asarray(plan.assembly.indptr)
            lo = int(indptr[np.nonzero(np.diff(indptr) >= 2)[0][0]])
            indices[[lo, lo + 1]] = indices[[lo + 1, lo]]
            return indices

        assert "assembly.column-order" in self._run(indices=swap)

    def test_batch_race_from_panel_aliasing(self):
        got = []
        for plan, check in zip(_element_plans(), (check_batch_races,
                                                  r_verify.check_batch_races)):
            s = plan.schedule
            panel = s.panel.copy()
            panel[0] = s.n_panels + 1  # lands in element b+1's slot 0
            findings = []
            check(dataclasses.replace(s, panel=panel), findings, bsz=2)
            got.append(_checks(findings))
        assert got[0] == got[1]
        assert got[0] & {"races.batch.padded-panel-bounds", "races.batch.cross-element"}

    def test_verify_plan_catches_in_place_corruption(self):
        reps = []
        for plan, verify in zip(_element_plans(), (verify_plan, r_verify.verify_plan)):
            gather = np.asarray(plan.assembly.gather).copy()
            gather[0] = gather[1]
            plan.assembly = dataclasses.replace(plan.assembly, gather=gather)
            reps.append(verify(plan))
        assert not reps[0].ok
        _same_report(*reps)
        with pytest.raises(PlanVerificationError):
            reps[0].raise_if_failed()


class TestShardFaultInjection:
    def test_overlapping_shard_bounds(self):
        from repro.launch.mesh import make_shard_mesh as r_make_shard_mesh

        (a, b), (ra, rb) = _mats(11, m=160)
        plans = (
            spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                        mesh=make_shard_mesh(1, devices=["cpu"])),
            r_spgemm_plan(ra, rb, tile=16, group=2, backend="jnp", cache=R_PlanCache(),
                          mesh=r_make_shard_mesh(1)),
        )
        got = []
        for plan, check in zip(plans, (check_shard_partition, r_verify.check_shard_partition)):
            shards = plan._shards
            assert shards
            bad = dataclasses.replace(shards[0], group_hi=shards[0].group_hi + 1)
            object.__setattr__(plan, "_shards", [bad] + list(shards[1:]))
            findings = []
            check(plan, findings)
            got.append(_checks(findings))
        assert got[0] == got[1]
        assert got[0] & {"shards.contiguity", "shards.coverage", "shards.bounds",
                         "shards.rebase", "shards.triple-span", "shards.panel-span"}


class TestCompactFaultInjection:
    """``tests/test_chain.py``'s compact-map faults, in both packages."""

    def _reports(self, mutate):
        reps = []
        for plan, verify in zip(_element_plans(output="compact"),
                                (verify_plan, r_verify.verify_plan)):
            plan.compact = mutate(plan.compact, plan)
            reps.append(verify(plan))
        _same_report(*reps)
        assert not reps[0].ok
        return _checks(reps[0].findings)

    def test_duplicate_gather(self):
        def dup(c, plan):
            g = np.asarray(c.gather).copy()
            g[1] = g[0]
            return dataclasses.replace(c, gather=g)

        assert "compact.gather-duplicate" in self._reports(dup)

    def test_out_of_subset_gather(self):
        def outside(c, plan):
            g = np.asarray(c.gather).copy()
            full = np.asarray(plan.assembly.gather)
            g[0] = np.setdiff1d(np.arange(int(full.max()) + 2), full)[0]
            return dataclasses.replace(c, gather=g)

        assert "compact.subset" in self._reports(outside)

    def test_permuted_gather_caught_by_rebuild(self):
        def flip(c, plan):
            return dataclasses.replace(c, gather=np.flip(np.asarray(c.gather)).copy())

        assert "compact.rebuild" in self._reports(flip)

    def test_unsorted_columns(self):
        def swap(c, plan):
            idx = np.asarray(c.indices).copy()
            row = int(np.argmax(np.diff(np.asarray(c.indptr)) >= 2))
            lo = int(c.indptr[row])
            idx[lo], idx[lo + 1] = idx[lo + 1], idx[lo]
            return dataclasses.replace(c, indices=idx)

        assert "compact.column-order" in self._reports(swap)


class TestLaunchFaultInjection:
    """Port only: the launch half of the race proof, over the runs a
    plan's executor staged (the JAX package has no such arrays)."""

    def _plan(self):
        plan, _ = _element_plans(tile=16)
        return plan, plan._executor._runs

    def test_staged_runs_are_checked(self):
        plan, runs = self._plan()
        rep = verify_plan(plan)
        assert rep.ok and "races.batch" in rep.checks_run

    def test_ptr_not_monotone(self):
        plan, runs = self._plan()
        i = int(np.argmax(np.diff(runs.ptr.numpy()) > 0))
        runs.ptr[i + 1] = runs.ptr[-1] + 1
        assert _checks(verify_plan(plan).findings) == {"races.batch.runs-ptr"}

    def test_entry_of_another_tile(self):
        plan, runs = self._plan()
        lens = np.diff(runs.ptr.numpy())
        assert (lens > 0).sum() >= 2
        runs.sub_row[0] = (runs.sub_row[0] + 1) % runs.group
        runs.panel[0] = (runs.panel[0] + (runs.sub_row[0] == 0)) % runs.n_panels
        assert _checks(verify_plan(plan).findings) == {"races.batch.runs-tile"}

    def test_slot_changed_within_bounds(self):
        plan, runs = self._plan()
        runs.b_slot[0] = (runs.b_slot[0] + 1) % int(plan._b_shape[0])
        assert _checks(verify_plan(plan).findings) == {"races.batch.runs-content"}

    def test_sharded_staged_runs(self):
        (a, b), _ = _mats(12, m=160)
        plan = spgemm_plan(a, b, tile=16, group=2, device="cpu", cache=PlanCache(),
                           mesh=make_shard_mesh(2, devices=["cpu"] * 2))
        runs = plan._executor.staged_runs()
        assert sorted(runs) == [0, 1] and verify_plan(plan).ok
        runs[1].a_slot[0] = (runs[1].a_slot[0] + 1) % 2
        assert _checks(verify_plan(plan).findings) == {"races.shards.runs-content"}


def _corrupt_artifact(store_dir, key, index, value):
    """Rewrite one entry of one array of the (single) stored artifact and
    re-sign the payload digest, so every integrity check of
    ``PlanStore.load`` still passes."""
    from repro_torch.spgemm.persist import _META_KEY, _payload_digest

    [path] = glob.glob(os.path.join(store_dir, "*.plan-torch.npz"))
    with np.load(path, allow_pickle=False) as npz:
        arrays = {n: npz[n].copy() for n in npz.files if n != _META_KEY}
        header = json.loads(bytes(np.asarray(npz[_META_KEY])).decode())
    arr = arrays[key]
    arr[index] = value(arr, header["meta"])
    header["digest"] = _payload_digest(arrays, header["meta"])
    payload = dict(arrays)
    payload[_META_KEY] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **payload)


# Two corruptions: the reference's (a duplicated assembly gather index)
# and an out-of-range A slot (a block read past A on the card).
CORRUPTIONS = {
    "asm.gather": (0, lambda g, meta: g[1], "assembly.gather-duplicate"),
    "sched.a_slot": (0, lambda s, meta: meta["a_shape"][0], "schedule.a-slot-bounds"),
}


class TestCorruptedArtifactNeverExecutes:
    """``validate="deep"`` and a digest-valid but corrupt disk artifact:
    the loader's verification fails, counts a load failure and falls back
    to a clean symbolic rebuild; the numeric phase never runs on it."""

    @pytest.mark.parametrize("key", sorted(CORRUPTIONS))
    def test_deep_validate_rejects_and_rebuilds(self, tmp_path, monkeypatch, key):
        (a, b), _ = _mats(13, integer=True)
        cold = spgemm_plan(a, b, tile=8, group=2, device="cpu",
                           cache=PlanCache(disk_dir=str(tmp_path)))
        index, value, _ = CORRUPTIONS[key]
        _corrupt_artifact(str(tmp_path), key, index, value)
        runs = []
        for name in ("_run_schedule", "_run_schedule_batch"):
            real = getattr(executor_mod, name)
            monkeypatch.setattr(executor_mod, name,
                                lambda *a, _real=real, **k: (runs.append(1), _real(*a, **k))[1])
        cache = PlanCache(disk_dir=str(tmp_path))
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache, validate="deep")
        assert runs == [], "the numeric phase ran while loading"
        assert cache.stats()["load_failures"] == 1
        assert plan.report.schedule_builds == 1 and plan.report.loads == 0
        assert verify_plan(plan).ok
        for f in ("a_slot", "b_slot", "panel", "sub_row", "start"):
            assert np.array_equal(getattr(plan.schedule, f), getattr(cold.schedule, f))
        assert np.array_equal(plan.assembly.gather, cold.assembly.gather)
        assert np.array_equal(plan.execute().data, cold.execute().data)

    @pytest.mark.parametrize("key", sorted(CORRUPTIONS))
    def test_without_deep_validate_corruption_loads(self, tmp_path, key):
        """Control: the store's digest alone cannot catch a re-signed
        corruption; that is the gap ``validate="deep"`` closes."""
        (a, b), _ = _mats(13)
        spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
        index, value, check = CORRUPTIONS[key]
        _corrupt_artifact(str(tmp_path), key, index, value)
        cache = PlanCache(disk_dir=str(tmp_path))
        plan = spgemm_plan(a, b, tile=8, group=2, device="cpu", cache=cache)
        assert cache.stats()["load_failures"] == 0 and plan.report.load_hits >= 1
        rep = verify_plan(plan)
        assert not rep.ok and check in _checks(rep.findings)


class TestStoreAudit:
    def test_orphaned_alias_reported_and_pruned(self, tmp_path):
        from repro_torch.spgemm.persist import PlanStore

        store = PlanStore(str(tmp_path))
        k_live, k_dead = ("live", 1), ("dead", 2)
        arrays = {"x": np.arange(4, dtype=np.int32)}
        store.save(k_live, arrays, {"kind": "t"})
        store.save(k_dead, arrays, {"kind": "t"})
        store.alias_put("tok-live", repr(k_live))
        store.alias_put("tok-dead", repr(k_dead))
        os.unlink(store.path_for(k_dead))
        assert store.alias_get("tok-live") == repr(k_live)
        assert store.alias_get("tok-dead") is None
        report = store.audit()
        assert report["orphaned"] == ["tok-dead"] and report["pruned"]
        assert report["files"] == 1
        clean = store.audit()
        assert clean["orphaned"] == [] and clean["aliases"] == 1

    def test_audit_clean_store(self, tmp_path):
        from repro_torch.spgemm.persist import PlanStore

        assert PlanStore(str(tmp_path)).audit() == {
            "files": 0, "bytes": 0, "aliases": 0, "orphaned": [], "pruned": False}


class TestKernelLint:
    """The K1/K2 launch lint flags each fault a launch would trip over."""

    def _plan(self, tile=16, **kw):
        (a, b), _ = _mats(14)
        return spgemm_plan(a, b, tile=tile, group=2, device="cpu", cache=PlanCache(), **kw)

    def test_clean_at_kernel_tiles(self):
        assert lint_plan_kernel_specs(self._plan()) == []
        assert lint_plan_kernel_specs(self._plan(tile=(16, 32, 48))) == []

    def test_a_slot_past_its_batch_element(self):
        plan = self._plan()
        na = int(plan._a_shape[0])
        plan._executor._runs.a_slot[0] = na  # element 0 reads element 1's block 0
        findings = lint_plan_kernel_specs(plan, bsz=2)
        assert _checks(findings) == {"kernel.index-map.batch"}
        assert f"reads block {2 * na}" in findings[0].message

    def test_tile_dim_24(self):
        assert _checks(lint_plan_kernel_specs(self._plan(tile=(16, 24, 16)))) == {
            "kernel.tile-dims"}

    def test_bsz_past_grid_y(self):
        plan = self._plan()
        assert lint_plan_kernel_specs(plan, bsz=65535) == []
        assert _checks(lint_plan_kernel_specs(plan, bsz=65536)) == {"kernel.grid"}

    def test_shared_memory_over_the_limit(self, monkeypatch):
        plan = self._plan()
        need = k1_smem_bytes(torch.float32, 16, 16, 16)
        assert lint_plan_kernel_specs(plan, smem_limit=need) == []
        monkeypatch.setattr(kernel_lint, "H100_SMEM_OPTIN_BYTES", need - 1)
        assert _checks(lint_plan_kernel_specs(plan)) == {"kernel.smem"}

    def test_mirror_equals_the_librarys_card_values(self):
        """What ``gustavson_spgemm_smem_bytes`` and ``_threads`` return is
        ``smem_bytes<T, KC>`` and ``Config::threads`` of the CUDA source:
        here that formula is evaluated at the source's own ``kStages`` and
        ``kMaxThreads`` (read from its text) and held against the mirror.
        The card test ``test_smem_mirror_equals_the_librarys_export``
        compares the mirror with the built library's export itself."""
        import re

        text = kernel_lint._SOURCE.read_text()
        assert lint_kernel_module(source=text) == []
        stages, max_threads = (
            int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("kStages", "kMaxThreads"))
        dims = range(16, 129, 16)
        for bm, bk, bn in ((m, k, n) for m in dims for k in dims for n in dims):
            kc = 32 if bk % 32 == 0 else 16
            tm, tn = 4, 4
            if bm * bn >= 64 * 64:
                tm, tn = 8, 4 if (bm // 8) * (bn // 4) <= max_threads else 8
            assert kernel_lint.k1_threads(bm, bk, bn) == (bm // tm) * (bn // tn)
            for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
                ring = size * stages * (bm * (kc + 16 // size) + kc * bn)
                work = 0 if size == 4 else 4 * (bm * (kc + 4) + kc * bn)
                assert k1_smem_bytes(dtype, bm, bk, bn) == ring + work, (dtype, bm, bk, bn)
        assert k1_smem_bytes(torch.float32, 24, 16, 16) == 0

    def test_every_kernel_tile_fits_the_h100(self):
        tiles = [(m, k, n) for m in range(16, 129, 16) for k in range(16, 129, 16)
                 for n in range(16, 129, 16)]
        for dtype in (torch.float32, torch.bfloat16):
            assert all(kernel_lint.lint_launch_config(t, dtype) == [] for t in tiles)

    def test_source_lint_catches_a_changed_source(self):
        text = kernel_lint._SOURCE.read_text()
        assert lint_kernel_module(source=text) == []
        bad = text.replace("float* __restrict__ out", "__nv_bfloat16* __restrict__ out")
        bad = bad.replace("dim3(g.n_tiles, g.bsz)", "dim3(g.bsz, g.n_tiles)")
        bad = bad.replace("constexpr int kStages = 3;", "constexpr int kStages = 4;")
        assert _checks(lint_kernel_module(source=bad)) == {
            "kernel.accum-dtype", "kernel.launch-geometry", "kernel.smem-mirror"}
