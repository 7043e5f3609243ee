"""End-to-end plan/execute SpGEMM pipeline on the card (block) path.

The paper's host pre-processing "only needs to be performed once"
(Sec. 4.3). ``spgemm_plan`` is that statement as an API: ONE call runs the
sparse-native format conversion (no dense round-trip), the symbolic
block-Gustavson phase (C structure + static triple schedule + the output
assembly map), schedule padding, and device staging; everything after
that is numeric-only, through K1 (``execute``) and K2 (``execute_batch``)
on the card (``--device cuda``, the default; ``--device cpu`` runs their
plain versions). The final sections re-plan the same pattern on a
4-shard mesh (``spgemm_plan(..., mesh=...)``) and — with ``--pipeline``
— stream it through the async submit/collect pipeline.

The JAX package forces 4 host devices through ``XLA_FLAGS`` for the
sharded section; that has no counterpart here. ``make_shard_mesh(4,
devices=[device] * 4)`` lays the four shards on the one device (the card,
or the CPU), each shard a program of its own, and the sharded result
must still equal the single plan's.

Which numeric entry point to use
--------------------------------
* ``plan.execute(a_vals, b_vals)`` — one result, now. Simplest; each call
  serializes rebind, H2D, kernel, assembly, and D2H. Use it for
  request/response calls and whenever latency of *this one step* is all
  that matters.
* ``plan.execute_batch(a_batch, b_batch)`` — many independent value sets
  that are all available at once. One batched kernel launch (K2) per
  cache-sized chunk; highest device efficiency, but the whole batch
  lands together (no early results).
* ``plan.pipeline(depth) / execute_async / execute_stream`` — a *stream*
  of value sets arriving over time (the serving shape). ``submit`` only
  dispatches — step s+1's value generation + staging overlaps step s's
  kernel, results materialize at ``collect`` — so throughput approaches
  the kernel rate while each result is still available as soon as it is
  done. ``depth=2`` is the paper's double buffer; results are
  bitwise-equal to sequential ``execute`` calls.

    PYTHONPATH=src python examples_torch/spgemm_pipeline.py [--pipeline]
    PYTHONPATH=src python examples_torch/spgemm_pipeline.py --device cpu
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.gustavson import spgemm_gustavson
from repro_torch.data.pipeline import SpGEMMValueStream
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.sparse.convert import to_csr
from repro_torch.sparse.formats import COO
from repro_torch.sparse.io import read_matrix_market, write_matrix_market
from repro_torch.sparse.random import suite_matrix
from repro_torch.spgemm import PlanCache, default_cache, schedule_build_count, spgemm_plan

TILE = 64
GROUP = 4


def main():
    parser = argparse.ArgumentParser(description="plan/execute SpGEMM demo")
    parser.add_argument("--pipeline", action="store_true",
                        help="also run the async streaming (submit/collect) "
                             "serving section")
    parser.add_argument("--steps", type=int, default=16,
                        help="streaming steps for the --pipeline section")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dev = args.device

    # --- host program: load the raw matrix file --------------------------
    a_small = suite_matrix("scircuit", scale=0.005)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scircuit.mtx")
        write_matrix_market(path, a_small)
        a = to_csr(read_matrix_market(path))
    print(f"loaded: {a}")

    # B = A^T (C = A @ A^T for a change), still element-level sparse.
    a_coo = a.to_coo()
    b_coo = COO(a_coo.col, a_coo.row, a_coo.val, (a.shape[1], a.shape[0]))

    # --- plan: ALL amortizable work happens here, once -------------------
    builds_before = schedule_build_count()
    plan = spgemm_plan(a, b_coo, tile=TILE, group=GROUP, device=dev)
    rep = plan.report
    print(f"plan: {rep.nnzb_a} A blocks, {rep.nnzb_b} B blocks, "
          f"{rep.num_triples} triples, {rep.n_panels} panels, "
          f"B fetches {rep.b_fetches} (block OMAR {rep.block_omar:.1f}%)")

    # --- execute: numeric phase only --------------------------------------
    c = plan.execute()
    ref = spgemm_gustavson(to_csr(a_coo), to_csr(b_coo))
    err = np.abs(c.todense() - ref.todense()).max()
    print(f"C: {c}  max|err| vs Gustavson oracle = {err:.2e}")
    assert err < 1e-2

    # --- serving loop: fresh values, same pattern, zero symbolic work -----
    stream = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7)
    for step in range(3):
        a_vals, b_vals = stream.values_at(step)
        c_step = plan.execute(a_vals, b_vals)
        ref_step = spgemm_gustavson(
            to_csr(COO(plan.a_pattern.row, plan.a_pattern.col, a_vals, a_coo.shape)),
            to_csr(COO(plan.b_pattern.row, plan.b_pattern.col, b_vals, b_coo.shape)),
        )
        err = np.abs(c_step.todense() - ref_step.todense()).max()
        print(f"step {step}: C nnz={c_step.nnz}  max|err|={err:.2e}")
        assert err < 1e-2
    assert schedule_build_count() == builds_before + 1, "symbolic phase re-ran!"

    # --- batched serving: one K2 launch over the batch --------------------
    # The same value stream in batch mode; one execute_batch call runs the
    # whole batch (rebind + kernel + assembly) with one batched launch.
    batch = 4
    stream_b = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=7, batch=batch)
    av, bv = stream_b.values_batch_at(0)
    cs = plan.execute_batch(av, bv)
    for i, c_i in enumerate(cs):
        c_one = plan.execute(av[i], bv[i])
        err = np.abs(c_i.todense() - c_one.todense()).max()
        assert err < 1e-3, f"batch element {i} diverged: {err:.2e}"
    print(f"execute_batch({batch}): all elements match single executes")
    assert schedule_build_count() == builds_before + 1, "symbolic phase re-ran!"

    # --- cache: pattern-equal request returns the identical plan ----------
    plan2 = spgemm_plan(a, b_coo, tile=TILE, group=GROUP, device=dev)
    assert plan2 is plan, "expected a cache hit"
    print(f"plan cache: hits={default_cache().stats.hits} "
          f"executes={rep.executes} schedule_builds={rep.schedule_builds}")

    # --- warm restart: the symbolic phase survives the process ------------
    # PlanCache(disk_dir=...) persists the value-independent artifacts
    # (triple schedule, scatter indices, assembly map) to disk; a restarted
    # worker rehydrates the plan instead of re-running the symbolic phase.
    # In production, point REPRO_TORCH_SPGEMM_PLAN_DIR at a shared
    # directory and the process-default cache does this with zero code
    # changes:
    #
    #     REPRO_TORCH_SPGEMM_PLAN_DIR=/var/cache/spgemm python serve.py
    #
    # Here both "processes" are fresh PlanCache instances over one directory.
    with tempfile.TemporaryDirectory() as plan_dir:
        worker1 = spgemm_plan(a, b_coo, tile=TILE, group=GROUP, device=dev,
                              cache=PlanCache(disk_dir=plan_dir))
        c_cold = worker1.execute()
        # ... the worker restarts: new cache, same directory, same pattern ...
        restarted = PlanCache(disk_dir=plan_dir)
        worker2 = spgemm_plan(a, b_coo, tile=TILE, group=GROUP, device=dev,
                              cache=restarted)
        assert worker2.report.schedule_builds == 0, "warm start rebuilt!"
        assert worker2.report.load_hits >= 1
        c_warm = worker2.execute()
        assert np.array_equal(c_cold.data, c_warm.data), "warm C diverged"
        s = restarted.stats()
        print(f"warm restart: schedule_builds={worker2.report.schedule_builds} "
              f"load_hits={worker2.report.load_hits} "
              f"disk_files={s['disk_files']} disk_kb={s['disk_bytes'] // 1024}")

    # --- sharded serving: the same pattern partitioned over 4 shards ------
    # The mesh extends the cache key, so this builds a second (sharded)
    # plan; A values are row-sharded, B replicated, C concatenated along
    # the precomputed indptr boundaries — results match the single plan
    # exactly. The four shards share the one device.
    mesh = make_shard_mesh(4, devices=[dev] * 4)
    plan_sh = spgemm_plan(a, b_coo, tile=TILE, group=GROUP, device=dev, mesh=mesh)
    stats = plan_sh.shard_stats()
    print(f"sharded plan: {stats['n_shards']} shards, per-shard triples "
          f"{stats['triples']} (imbalance {stats['imbalance']:.2f})")
    a_vals, b_vals = stream.values_at(0)
    c_sh = plan_sh.execute(a_vals, b_vals)
    c_one = plan.execute(a_vals, b_vals)
    err = np.abs(c_sh.todense() - c_one.todense()).max()
    assert err < 1e-5, f"sharded result diverged: {err:.2e}"
    cs_sh = plan_sh.execute_batch(av, bv)
    for i, c_i in enumerate(cs_sh):
        err = np.abs(c_i.todense() - cs[i].todense()).max()
        assert err < 1e-5, f"sharded batch element {i} diverged: {err:.2e}"
    print(f"sharded execute + execute_batch({batch}) match the single-device "
          f"plan  (cache stats: {default_cache().stats()})")

    # --- async streaming serving (--pipeline): submit/collect -------------
    # The pipeline splits the numeric phase into stage (H2D + rebind) ->
    # kernel -> assembly/collect and keeps `depth` steps in flight, so step
    # s+1's value generation and staging overlap step s's kernel; results
    # are bitwise-equal to sequential execute() calls and come back in
    # order.
    if args.pipeline:
        # Explicit submit/collect: two steps in flight, out-of-order collect.
        with plan.pipeline(depth=2) as pipe:
            t0 = pipe.submit(*stream.values_at(0))
            t1 = pipe.submit(*stream.values_at(1))  # overlaps t0's kernel
            c1 = pipe.collect(t1)  # out-of-order is fine
            c0 = t0.result()
        for s, c_p in ((0, c0), (1, c1)):
            assert np.array_equal(c_p.data, plan.execute(*stream.values_at(s)).data)
        print("pipeline: submit/collect (out-of-order) matches execute bitwise")

        # Streaming: SpGEMMValueStream.value_iter generates values in a
        # prefetch thread; execute_stream keeps the pipeline full.
        n = max(2, args.steps)
        t_start = time.perf_counter()
        seen = sum(1 for _ in plan.execute_stream(stream.value_iter(steps=n), depth=2))
        pipe_s = time.perf_counter() - t_start
        assert seen == n
        print(f"pipeline: streamed {seen} steps at depth 2 "
              f"({n / pipe_s:.0f} steps/s), results ordered and bitwise-equal "
              f"to execute")
    print("OK")


if __name__ == "__main__":
    main()
