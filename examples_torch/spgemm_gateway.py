"""Multi-tenant SpGEMM serving through the gateway front end.

Many tenants hammer many sparsity patterns concurrently; each pattern's
symbolic plan is built once (PlanCache + ``pattern_token`` fast key) and
the gateway does the serving-side work the per-plan pipeline cannot:

* **micro-batching** — same-pattern requests landing within the batch
  window dispatch as ONE pipeline submission (watch ``batch_fill`` > 1
  under the bursty phase; results stay bitwise-equal to per-request
  ``plan.execute``);
* **fair scheduling** — deficit round-robin by pending value *bytes*
  across patterns over a bounded pool of live pipelines, so the hot
  tenant's backlog cannot starve the cold one;
* **backpressure** — queue depth, in-flight byte budget, and plan-cache
  byte pressure all shed with explicit typed outcomes
  (``GatewayResult.outcome``), never exceptions out of the scheduler and
  never hangs;
* **metrics** — per-pattern queue depth, batch fill, p50/p99 latency,
  throughput, and shed counts in a shared ``MetricsRegistry`` that a
  ``Heartbeat`` exports as JSON lines while the demo runs.

Every micro-batch runs through K2 on the card (``--device cuda``, the
default; ``--device cpu`` runs its plain version). The patterns are
planned at tile 16, the smallest tile K1/K2 take on the card, where the
JAX package's demo takes 8.

    PYTHONPATH=src python examples_torch/spgemm_gateway.py
    PYTHONPATH=src python examples_torch/spgemm_gateway.py --device cpu --bursts 2
"""
import argparse
import json
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.data.pipeline import SpGEMMValueStream
from repro_torch.runtime.heartbeat import Heartbeat, MetricsRegistry
from repro_torch.sparse.random import random_coo
from repro_torch.spgemm import Outcome, PlanCache, SpGEMMGateway

def pattern(seed, m, k, n, density=0.06):
    a = random_coo(m, k, density, "uniform", seed=seed).sum_duplicates()
    b = random_coo(k, n, density, "uniform", seed=seed + 1).sum_duplicates()
    return a, b


def same_csr(x, y):
    return (np.array_equal(x.indptr, y.indptr)
            and np.array_equal(x.indices, y.indices)
            and np.array_equal(x.data, y.data))


def main():
    parser = argparse.ArgumentParser(description="multi-tenant gateway demo")
    parser.add_argument("--bursts", type=int, default=6)
    parser.add_argument("--burst-size", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    # --- gateway + metrics ---------------------------------------------------
    # One registry shared by the gateway and the heartbeat: every beat line
    # carries the live per-pattern counters.
    metrics = MetricsRegistry()
    cache = PlanCache()
    gw = SpGEMMGateway(cache=cache, metrics=metrics, max_pipelines=2, depth=2,
                       max_batch=8, batch_window=0.002)

    # Two tenants, two patterns. register() resolves through the PlanCache
    # with the token as the warm-path fast key — a re-register is a cache hit.
    plans = {
        "tenant0/attn": gw.register("tenant0/attn", *pattern(0, 96, 72, 80),
                                    tile=16, group=2, device=args.device),
        "tenant1/mlp": gw.register("tenant1/mlp", *pattern(4, 64, 64, 64, 0.08),
                                   tile=16, group=2, device=args.device),
    }
    streams = {
        tok: SpGEMMValueStream(p.a_pattern, p.b_pattern, seed=7 + i)
        for i, (tok, p) in enumerate(plans.items())
    }
    print(f"registered {len(plans)} patterns; cache: {cache.stats()}")

    with tempfile.TemporaryDirectory() as beat_dir:
        hb = Heartbeat(beat_dir, interval=0.2, metrics=metrics)
        hb.start()

        # --- phase 1: bursty concurrent tenants ------------------------------
        # Each tenant thread fires bursts of same-instant requests; arrivals
        # within the 2 ms window coalesce into single pipeline dispatches.
        results = {}
        lock = threading.Lock()

        def tenant(tok):
            for burst in range(args.bursts):
                tickets = []
                for j in range(args.burst_size):
                    step = burst * args.burst_size + j
                    tickets.append(
                        (step, gw.submit(tok, *streams[tok].values_at(step))))
                for step, t in tickets:
                    res = t.wait(timeout=300)
                    with lock:
                        results[(tok, step)] = res
                time.sleep(0.002)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tenant, args=(tok,)) for tok in plans]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        elapsed = time.perf_counter() - t0

        n_ok = sum(1 for r in results.values() if r.outcome is Outcome.OK)
        print(f"\nphase 1: {n_ok}/{len(results)} requests OK in {elapsed:.2f}s "
              f"({n_ok / elapsed:.1f} req/s aggregate)")

        # Verify a sample bitwise against direct plan.execute.
        checked = 0
        for (tok, step), res in sorted(results.items())[:6]:
            ref = plans[tok].execute(*streams[tok].values_at(step))
            assert same_csr(ref, res.value), (tok, step)
            checked += 1
        print(f"bitwise check vs plan.execute: {checked}/{checked} equal")

        stats = gw.stats()
        print("\npattern,completed,dispatches,batch_fill,p50_ms,p99_ms,"
              "throughput_rps,shed")
        for tok, ps in stats["patterns"].items():
            lat = ps["latency_s"]
            print(f"{tok},{ps['completed']},{ps['dispatches']},"
                  f"{ps['batch_fill']:.2f},{lat['p50'] * 1e3:.2f},"
                  f"{lat['p99'] * 1e3:.2f},{ps['throughput_rps']:.1f},"
                  f"{ps['shed_total']}")
            assert ps["batch_fill"] > 1.0, "bursty arrivals should micro-batch"

        hb.stop()
        beats = sorted(os.listdir(beat_dir))
        with open(f"{beat_dir}/{beats[-1]}") as f:
            last = json.load(f)
        n_metrics = len(last.get("metrics", {}))
        print(f"\nheartbeat exported {len(beats)} beats; last beat carries "
              f"{n_metrics} metric series (e.g. "
              f"gateway.tenant0/attn.latency_s p99="
              f"{last['metrics']['gateway.tenant0/attn.latency_s']['p99']:.4f}s)")

    gw.close()

    # --- phase 2: overload sheds, not hangs ----------------------------------
    # A byte budget sized for ~2 requests: the rest resolve IMMEDIATELY with
    # Outcome.SHED_BYTES; admitted work still completes and verifies.
    tok = "tenant0/attn"
    plan = plans[tok]
    gw2 = SpGEMMGateway(cache=cache, metrics=metrics, max_pipelines=1,
                        max_inflight_bytes=2 * plan.value_nbytes() + 16,
                        start=False)
    gw2.register_plan(tok, plan)
    tickets = [gw2.submit(tok, *streams[tok].values_at(s)) for s in range(8)]
    shed = [t.wait(0) for t in tickets if t.done()]
    gw2.start()
    done = [t.wait(timeout=300) for t in tickets]
    gw2.close()
    ok = [r for r in done if r.outcome is Outcome.OK]
    print(f"\nphase 2 (budget ~2 requests): submitted {len(tickets)}, "
          f"shed {len(shed)} at admission "
          f"({sorted({r.outcome.value for r in shed})}), {len(ok)} completed")
    assert all(r.outcome is Outcome.SHED_BYTES for r in shed)
    assert all(
        same_csr(plan.execute(*streams[tok].values_at(s)), r.value)
        for s, r in enumerate(done) if r.outcome is Outcome.OK
    )
    print("admitted results verified; overload shed typed, nothing hung")


if __name__ == "__main__":
    main()
