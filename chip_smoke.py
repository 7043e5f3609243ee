#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SpGEMM main path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure (build error, launch error, mismatch) ends
the run with a nonzero exit code and no result line:

1. the card's name and power limit (nvidia-smi);
2. build the block-Gustavson CUDA kernel from source (nvcc, sm_90a);
3. hold the kernel (K1 single, K2 batched) against its plain PyTorch
   version at the JAX package's kernel-test shapes: float32 within 1e-5,
   bfloat16 within 2e-2, small integers bitwise, K2 against a loop of K1
   bitwise;
4. main path on poisson3Da at its published size: ``spgemm_plan`` on the
   card, three ``execute`` calls and one ``execute_batch`` of 4 with fresh
   values from a numpy seed, each checked against the numpy Gustavson
   oracle (rtol = atol = 1e-4, the JAX package's own plan-vs-oracle
   tolerance); the launch counts show K1 and K2 ran;
5. 2cubes_sphere at its published size, one ``execute``, checked the same
   way;
6. timings with CUDA events (median after warm-up) of each kernel, its
   plain version and cuSPARSE CSR @ CSR (``torch.sparse``, a yardstick the
   port never calls), the least time the card could take, and the
   end-to-end ``execute`` time; one ``{"kernels": [...]}`` line;
7. the last line: ``{"ok": true, "device": {...}}``.

Needs one CUDA device; exits nonzero without one. TF32 is switched off, so
every float32 product here is full float32.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.gustavson import spgemm_gustavson  # noqa: E402
from repro_torch.core.schedule import build_spgemm_schedule  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.gustavson_spgemm import (  # noqa: E402
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import COO, CSR  # noqa: E402
from repro_torch.sparse.random import random_block_sparse, suite_matrix  # noqa: E402
from repro_torch.spgemm import spgemm_plan  # noqa: E402

SEED = 0
TILE, GROUP = 64, 4
# The JAX package's kernel-test shapes (tests/test_kernels.py).
KERNEL_SHAPES = [
    ((128, 128, 128), (32, 32, 32), 1),
    ((256, 128, 192), (64, 64, 64), 2),
    ((256, 384, 256), (64, 64, 128), 4),
]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ORACLE_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM bandwidth. The kernel's float32 path uses no tensor cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOURCE = "src/repro_torch/kernels/csrc/gustavson_spgemm.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of ``fn`` in ms; ``fn`` returns host results."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def reset_counts() -> None:
    spgemm_scheduled.launches = 0
    spgemm_scheduled_batch.launches = 0


def counts() -> dict:
    return {"spgemm_scheduled": spgemm_scheduled.launches,
            "spgemm_scheduled_batch": spgemm_scheduled_batch.launches}


# -- phase 3: kernel against its plain version --------------------------------

def kernel_case(shape, blocks, group, seed, integer):
    m, k, n = shape
    bm, bk, bn = blocks
    ad = random_block_sparse(m, k, (bm, bk), 0.35, seed=seed)
    bd = random_block_sparse(k, n, (bk, bn), 0.4, seed=seed + 1)
    if integer:
        rng = np.random.default_rng(seed + 100)
        ad = np.where(ad != 0, rng.integers(1, 4, ad.shape), 0).astype(np.float32)
        bd = np.where(bd != 0, rng.integers(-3, 4, bd.shape), 0).astype(np.float32)
    a, b = to_bcsv(ad, (bm, bk), group), to_bcsr(bd, (bk, bn))
    return a, b, build_spgemm_schedule(a, b)


def phase_kernel_checks(dev) -> None:
    for shape, blocks, group in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for integer in (False, True):
                a, b, sch = kernel_case(shape, blocks, group, 1, integer)
                runs = stage_runs(sch, dev)
                at = torch.from_numpy(a.blocks).to(dev, dtype)
                bt = torch.from_numpy(b.blocks).to(dev, dtype)
                got = spgemm_scheduled(at, bt, runs)
                want = ref.spgemm_scheduled_ref(
                    at, bt, sch.a_slot, sch.b_slot, sch.panel, sch.sub_row,
                    sch.n_panels, sch.group)
                torch.cuda.synchronize()
                err = float((got - want).abs().max()) if got.numel() else 0.0
                if integer:
                    check(torch.equal(got, want),
                          f"K1 {shape} {dtype} small integers not bitwise (err {err})")
                else:
                    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
                log(f"  K1 {shape} tile {blocks} group {group} {str(dtype)[6:]}"
                    f"{' int' if integer else ''}: max_abs_err {err:.3g}")
            # K2 with 3 value sets against a loop of K1, bitwise.
            g = torch.Generator(device=dev).manual_seed(SEED)
            a_sets = torch.randn((3,) + a.blocks.shape, generator=g, device=dev).to(dtype)
            b_sets = torch.randn((3,) + b.blocks.shape, generator=g, device=dev).to(dtype)
            batch = spgemm_scheduled_batch(a_sets.flatten(0, 1), b_sets.flatten(0, 1),
                                           runs, bsz=3)
            for i in range(3):
                check(torch.equal(batch[i], spgemm_scheduled(a_sets[i], b_sets[i], runs)),
                      f"K2 element {i} differs from K1 at {shape} {dtype}")
            plain = ref.spgemm_scheduled_batch_ref(
                a_sets.flatten(0, 1), b_sets.flatten(0, 1), sch.a_slot, sch.b_slot,
                sch.panel, sch.sub_row, sch.n_panels, sch.group, 3)
            torch.testing.assert_close(batch, plain, rtol=TOL[dtype], atol=TOL[dtype])
            log(f"  K2 bsz 3 {shape} {str(dtype)[6:]}: bitwise equal to looped K1")


# -- phases 4-5: the main path ------------------------------------------------

def compare_to_oracle(c: CSR, oracle: CSR, what: str) -> float:
    """``c`` against the Gustavson oracle: equal values at the oracle's
    nonzeros, zero at every other stored entry of ``c`` (the plan stores
    C's block-structural pattern). Returns the largest absolute
    difference."""
    n = c.shape[1]
    check(c.shape == oracle.shape, f"{what}: shape {c.shape} vs {oracle.shape}")
    key = np.repeat(np.arange(c.shape[0], dtype=np.int64), np.diff(c.indptr)) * n + c.indices
    o_key = (np.repeat(np.arange(oracle.shape[0], dtype=np.int64), np.diff(oracle.indptr)) * n
             + oracle.indices)
    pos = np.searchsorted(key, o_key)
    check(key.size > 0 and bool(np.all(pos < key.size))
          and np.array_equal(key[np.minimum(pos, key.size - 1)], o_key),
          f"{what}: oracle nonzeros outside the stored pattern")
    check(bool(np.all(np.isfinite(c.data))), f"{what}: non-finite values")
    np.testing.assert_allclose(c.data[pos], oracle.data, rtol=ORACLE_TOL, atol=ORACLE_TOL,
                               err_msg=what)
    rest = np.ones(key.size, bool)
    rest[pos] = False
    off = float(np.abs(c.data[rest]).max(initial=0.0))
    check(off <= ORACLE_TOL, f"{what}: entries outside the oracle's pattern not zero ({off})")
    return max(float(np.abs(c.data[pos] - oracle.data).max(initial=0.0)), off)


def check_against_oracle(c: CSR, a: CSR, a_vals, b_vals, what: str) -> float:
    """C = A·A from the plan, with A's pattern carrying ``a_vals`` on the
    left and ``b_vals`` on the right, against the Gustavson oracle."""
    oracle = spgemm_gustavson(CSR(a.indptr, a.indices, a_vals, a.shape),
                              CSR(a.indptr, a.indices, b_vals, a.shape))
    return compare_to_oracle(c, oracle, what)


def phase_main_path(dev, rng):
    a = suite_matrix("poisson3Da", scale=1.0, seed=SEED)
    t0 = time.perf_counter()
    plan = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev)
    plan_s = time.perf_counter() - t0
    r = plan.report
    log(f"  poisson3Da {a.shape} nnz {a.nnz}: plan {plan_s:.2f} s, triples "
        f"{r.num_triples}, panels {r.n_panels}, nnzb_a {r.nnzb_a}, nnzb_b "
        f"{r.nnzb_b}, structural nnz(C) {plan.assembly.nnz}")
    singles = [(rng.standard_normal(a.nnz, dtype=np.float32),
                rng.standard_normal(a.nnz, dtype=np.float32)) for _ in range(3)]
    a_batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
    b_batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
    chunk = plan._executor.batch_chunk()
    reset_counts()
    outs = [plan.execute(av, bv) for av, bv in singles]
    batch_outs = plan.execute_batch(a_batch, b_batch)
    torch.cuda.synchronize()
    launched = counts()
    log(f"  main path: 3 execute + execute_batch(4) (chunk {chunk}); launches {launched}")
    check(launched["spgemm_scheduled"] == 3, f"K1 launches {launched}")
    check(launched["spgemm_scheduled_batch"] == -(-4 // min(4, chunk)),
          f"K2 launches {launched}")
    errs = [check_against_oracle(c, a, av, bv, f"execute {i}")
            for i, (c, (av, bv)) in enumerate(zip(outs, singles))]
    errs += [check_against_oracle(c, a, a_batch[i], b_batch[i], f"execute_batch[{i}]")
             for i, c in enumerate(batch_outs)]
    for i in range(4):
        single = plan.execute(a_batch[i], b_batch[i])
        check(np.array_equal(single.data, batch_outs[i].data),
              f"execute_batch[{i}] differs from execute")
    log(f"  poisson3Da vs Gustavson oracle: max_abs_err {max(errs):.3g}; "
        f"execute_batch bitwise equal to looped execute")
    return a, plan, launched, chunk


def phase_second_matrix(dev, rng):
    a = suite_matrix("2cubes_sphere", scale=1.0, seed=SEED)
    t0 = time.perf_counter()
    plan = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev)
    plan_s = time.perf_counter() - t0
    r = plan.report
    log(f"  2cubes_sphere {a.shape} nnz {a.nnz}: plan {plan_s:.2f} s, triples "
        f"{r.num_triples}, panels {r.n_panels}, structural nnz(C) {plan.assembly.nnz}")
    av = rng.standard_normal(a.nnz, dtype=np.float32)
    bv = rng.standard_normal(a.nnz, dtype=np.float32)
    reset_counts()
    c = plan.execute(av, bv)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["spgemm_scheduled"] == 1, f"K1 launches {launched}")
    err = check_against_oracle(c, a, av, bv, "2cubes_sphere execute")
    log(f"  2cubes_sphere: launches {launched}; vs oracle max_abs_err {err:.3g}")
    return a, plan


# -- phase 6: timings -----------------------------------------------------------

def kernel_inputs(plan, dev, rng, bsz):
    """The kernel's operands at the main path's shapes: packed blocks
    rebound from fresh values (stacked for ``bsz`` > 1) on the card."""
    ex = plan._executor
    a_sets, b_sets = [], []
    for _ in range(bsz):
        av = torch.from_numpy(rng.standard_normal(plan.report.nnz_a, dtype=np.float32)).to(dev)
        bv = torch.from_numpy(rng.standard_normal(plan.report.nnz_b, dtype=np.float32)).to(dev)
        a_sets.append(torch.cat([av, av.new_zeros(1)]).index_select(0, ex._a_inv))
        b_sets.append(torch.cat([bv, bv.new_zeros(1)]).index_select(0, ex._b_inv))
    a_blocks = torch.cat(a_sets).reshape((bsz * ex.a_shape[0],) + ex.a_shape[1:])
    b_blocks = torch.cat(b_sets).reshape((bsz * ex.b_shape[0],) + ex.b_shape[1:])
    return a_blocks, b_blocks, ex._runs


def bound(plan, bsz) -> tuple:
    """Least time (ms) the card could take for the kernel's work on this
    plan: each input read once, each output written once, the flops at the
    float32 peak outside the tensor cores; the larger of the two."""
    ex = plan._executor
    bm, bk = ex.a_shape[1], ex.a_shape[2]
    bn = ex.b_shape[2]
    flops = 2.0 * plan.report.num_triples * bm * bk * bn * bsz
    runs = ex._runs
    nbytes = bsz * 4 * (np.prod(ex.a_shape) + np.prod(ex.b_shape)
                        + plan.report.n_panels * GROUP * bm * bn) \
        + 4 * (runs.ptr.numel() + runs.a_slot.numel() + runs.b_slot.numel())
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = float(nbytes) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"), flops, nbytes


def library_call(a: CSR, dev, rng):
    """cuSPARSE CSR @ CSR through torch.sparse for C = A·A with fresh
    values (int32 indices), checked against the Gustavson oracle; returns
    the call for timing."""
    vals = rng.standard_normal(a.nnz, dtype=np.float32)
    t = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int32)).to(dev),
                                torch.from_numpy(a.indices.astype(np.int32)).to(dev),
                                torch.from_numpy(vals).to(dev), a.shape,
                                check_invariants=False)
    res = t @ t
    crow = res.crow_indices().cpu().numpy()
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int32), np.diff(crow))
    got = CSR.from_coo(COO(rows, res.col_indices().cpu().numpy(), res.values().cpu().numpy(),
                           a.shape).sum_duplicates())
    del res
    av = CSR(a.indptr, a.indices, vals, a.shape)
    compare_to_oracle(got, spgemm_gustavson(av, av), "cuSPARSE CSR @ CSR")
    return lambda: t @ t


def phase_timings(a, plan, launched, chunk, dev, rng):
    entries, extra = [], {}
    a_blocks, b_blocks, runs = kernel_inputs(plan, dev, rng, 1)
    kernel = spgemm_scheduled(a_blocks, b_blocks, runs)
    plain = ref.spgemm_scheduled_ref(a_blocks, b_blocks, runs.a_slot, runs.b_slot,
                                     runs.panel, runs.sub_row, runs.n_panels, runs.group)
    torch.testing.assert_close(kernel, plain, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    err1 = float((kernel - plain).abs().max())
    del kernel, plain
    lib = library_call(a, dev, rng)
    lib_ms = time_ms(lib, reps=10)
    (b_ms, b_by), flops, nbytes = bound(plan, 1)
    k1_ms = time_ms(lambda: spgemm_scheduled(a_blocks, b_blocks, runs), reps=20)
    p1_ms = time_ms(lambda: ref.spgemm_scheduled_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row,
        runs.n_panels, runs.group), reps=5)
    log(f"  K1 poisson3Da: {k1_ms:.4f} ms ({flops / k1_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / k1_ms:.1%} of the bound), plain {p1_ms:.4f} ms, cuSPARSE {lib_ms:.4f} ms")
    entries.append({
        "name": "spgemm_scheduled", "route": "cuda", "source": SOURCE,
        "replaces": "src/repro/kernels/gustavson_spgemm.py:128",
        "launches": launched["spgemm_scheduled"], "max_abs_err": err1,
        "ms": k1_ms, "plain_ms": p1_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })

    # K2 at the main path's shape: execute_batch(4) ran chunks of `bsz`.
    bsz = min(4, chunk)
    ab, bb, runs = kernel_inputs(plan, dev, rng, bsz)
    k2 = spgemm_scheduled_batch(ab, bb, runs, bsz=bsz)
    p2 = ref.spgemm_scheduled_batch_ref(ab, bb, runs.a_slot, runs.b_slot, runs.panel,
                                        runs.sub_row, runs.n_panels, runs.group, bsz)
    torch.testing.assert_close(k2, p2, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    err2 = float((k2 - p2).abs().max())
    del k2, p2
    (b2_ms, b2_by), _, _ = bound(plan, bsz)
    k2_ms = time_ms(lambda: spgemm_scheduled_batch(ab, bb, runs, bsz=bsz), reps=20)
    p2_ms = time_ms(lambda: ref.spgemm_scheduled_batch_ref(
        ab, bb, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row, runs.n_panels,
        runs.group, bsz), reps=5)
    # No single torch call runs a batch of sparse products: bsz CSR @ CSR.
    lib2_ms = time_ms(lambda: [lib() for _ in range(bsz)], reps=5)
    log(f"  K2 poisson3Da bsz {bsz}: {k2_ms:.4f} ms, plain {p2_ms:.4f} ms, "
        f"cuSPARSE x{bsz} {lib2_ms:.4f} ms")
    entries.append({
        "name": "spgemm_scheduled_batch", "route": "cuda", "source": SOURCE,
        "replaces": "src/repro/kernels/gustavson_spgemm.py:186",
        "launches": launched["spgemm_scheduled_batch"], "max_abs_err": err2,
        "ms": k2_ms, "plain_ms": p2_ms, "bound_ms": b2_ms, "bound_by": b2_by,
        "library_ms": lib2_ms,
    })
    del ab, bb

    # K2 with the whole batch of 4 in one launch (not the main path's shape).
    ab, bb, runs = kernel_inputs(plan, dev, rng, 4)
    extra["K2_bsz4_ms"] = time_ms(lambda: spgemm_scheduled_batch(ab, bb, runs, bsz=4), reps=10)
    extra["K2_bsz4_bound_ms"] = bound(plan, 4)[0][0]
    del ab, bb

    # End to end, poisson3Da: host values in, host CSR out.
    vals = [rng.standard_normal(a.nnz, dtype=np.float32) for _ in range(2)]
    e2e_ms = host_ms(lambda: plan.execute(vals[0], vals[1]), reps=10)
    batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
    e2e_b_ms = host_ms(lambda: plan.execute_batch(batch, batch), reps=5)
    nnz_c = plan.assembly.nnz
    extra.update({
        "execute_ms": e2e_ms, "execute_values_per_s": nnz_c / (e2e_ms / 1e3),
        "execute_batch4_ms": e2e_b_ms,
        "execute_batch4_values_per_s": 4 * nnz_c / (e2e_b_ms / 1e3),
        "K1_tflops": flops / k1_ms / 1e9, "K1_bound_share": b_ms / k1_ms,
        "K1_flops": flops, "K1_bytes": float(nbytes),
    })
    extra["execute_stages_ms"] = breakdown(plan, dev, rng, reps=5)
    log(f"  execute poisson3Da stages (ms): {extra['execute_stages_ms']}")
    log(f"  execute poisson3Da end to end: {e2e_ms:.3f} ms "
        f"({extra['execute_values_per_s']:.4g} C values/s); execute_batch(4): "
        f"{e2e_b_ms:.3f} ms")
    return entries, extra


def breakdown(plan, dev, rng, reps: int) -> dict:
    """Median time (ms) of each stage of one element-plan ``execute``,
    run stage by stage through the calls ``execute`` makes: host value
    rebind, host-to-device copy of the values, value bind (gather), the
    kernel, the assembly gather, device-to-host copy of C's values, CSR
    wrap. Device stages are timed with CUDA events, the others with the
    host clock around a synchronize. ``bind_batch`` and ``assemble_batch``
    are the batched path's two gathers for one value set."""
    from repro_torch.spgemm.executor import _bind, _bind_batch

    ex, r = plan._executor, plan.report
    names = ("host_rebind", "h2d", "bind", "kernel", "assemble", "d2h", "wrap",
             "bind_batch", "assemble_batch")
    runs = {k: [] for k in names}
    for i in range(reps + 1):
        av = rng.standard_normal(r.nnz_a, dtype=np.float32)
        bv = rng.standard_normal(r.nnz_b, dtype=np.float32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan._rebind(av, plan._a_blocks, plan._a_scatter, r.nnz_a, "a_vals", plan._a_shape)
        plan._rebind(bv, plan._b_blocks, plan._b_scatter, r.nnz_b, "b_vals", plan._b_shape)
        t1 = time.perf_counter()
        a_d, b_d = torch.from_numpy(av).to(dev), torch.from_numpy(bv).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ev[0].record()
        a_blocks, b_blocks = _bind(a_d, ex._a_inv, ex.a_shape), _bind(b_d, ex._b_inv, ex.b_shape)
        ev[1].record()
        panels = spgemm_scheduled(a_blocks, b_blocks, ex._runs)
        ev[2].record()
        packed = panels.reshape(-1).index_select(0, ex._gather)
        ev[3].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = packed.cpu()
        t4 = time.perf_counter()
        plan._wrap_packed(host)
        t5 = time.perf_counter()
        evb = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        evb[0].record()
        _bind_batch(a_d[None], ex._a_inv, ex.a_shape)
        _bind_batch(b_d[None], ex._b_inv, ex.b_shape)
        evb[1].record()
        evb[2].record()
        panels.reshape(1, -1).index_select(1, ex._gather)
        evb[3].record()
        torch.cuda.synchronize()
        if i == 0:
            continue  # warm-up
        for k, v in zip(names, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, ev[0].elapsed_time(ev[1]),
                                ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3]),
                                (t4 - t3) * 1e3, (t5 - t4) * 1e3,
                                evb[0].elapsed_time(evb[1]), evb[2].elapsed_time(evb[3]))):
            runs[k].append(v)
    return {k: float(np.median(v)) for k, v in runs.items()}


def phase_second_timings(a, plan, dev, rng, extra):
    a_blocks, b_blocks, runs = kernel_inputs(plan, dev, rng, 1)
    (b_ms, b_by), flops, _ = bound(plan, 1)
    k_ms = time_ms(lambda: spgemm_scheduled(a_blocks, b_blocks, runs), reps=5)
    p_ms = time_ms(lambda: ref.spgemm_scheduled_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row,
        runs.n_panels, runs.group), reps=3, warmup=1)
    del a_blocks, b_blocks
    lib_ms = time_ms(library_call(a, dev, rng), reps=5)
    vals = [rng.standard_normal(a.nnz, dtype=np.float32) for _ in range(2)]
    e2e_ms = host_ms(lambda: plan.execute(vals[0], vals[1]), reps=3)
    extra["2cubes_execute_stages_ms"] = breakdown(plan, dev, rng, reps=3)
    log(f"  execute 2cubes_sphere stages (ms): {extra['2cubes_execute_stages_ms']}")
    extra.update({
        "2cubes_K1_ms": k_ms, "2cubes_plain_ms": p_ms, "2cubes_bound_ms": b_ms,
        "2cubes_bound_by": b_by, "2cubes_library_ms": lib_ms,
        "2cubes_execute_ms": e2e_ms, "2cubes_K1_tflops": flops / k_ms / 1e9,
    })
    log(f"  K1 2cubes_sphere: {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), bound "
        f"{b_ms:.3f} ms ({b_by}), plain {p_ms:.3f} ms, cuSPARSE {lib_ms:.3f} ms; "
        f"execute end to end {e2e_ms:.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    log("[1] card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, L2 "
        f"{torch.cuda.get_device_properties(0).L2_cache_size} bytes")

    log("[2] build")
    t0 = time.perf_counter()
    lib_path = _build.build("gustavson_spgemm")
    _build.load_gustavson()
    log(f"  built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    log("[3] kernel vs plain version")
    phase_kernel_checks(dev)

    log("[4] main path: poisson3Da")
    a, plan, launched, chunk = phase_main_path(dev, rng)

    log("[5] 2cubes_sphere")
    a2, plan2 = phase_second_matrix(dev, rng)

    log("[6] timings")
    entries, extra = phase_timings(a, plan, launched, chunk, dev, rng)
    del plan
    phase_second_timings(a2, plan2, dev, rng, extra)
    del plan2
    extra["total_s"] = time.perf_counter() - t_start
    log("timing " + json.dumps(extra))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
