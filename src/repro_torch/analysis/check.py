"""Static-analysis CLI: verify paper-matrix plans without executing them.

    PYTHONPATH=src python -m repro_torch.analysis.check --paper-matrices \\
        [--matrices NAMES] [--scale S] [--shards N] [--lock-lint] [--store DIR]

For each paper matrix (:mod:`repro_torch.configs.paper_matrices`) the
CLI builds, in an isolated :class:`~repro_torch.spgemm.cache.PlanCache`
over a temporary disk tier, an element plan, a block plan, optionally a
sharded plan (``--shards N``: ``N`` shards of one device, through
:func:`~repro_torch.launch.mesh.make_shard_mesh` with the device
repeated) and a disk-rehydrated plan, all with ``validate="deep"``, and
runs :func:`repro_torch.analysis.verify.verify_plan` plus the K1/K2 launch
lint on each. ``--lock-lint`` also runs a scripted gateway/pipeline
workload under the lock-order instrumentation
(:mod:`repro_torch.analysis.locks`) and fails on acquisition-graph cycles.
``--store DIR`` (or ``REPRO_TORCH_SPGEMM_PLAN_DIR``) audits an on-disk
:class:`~repro_torch.spgemm.persist.PlanStore`: orphaned aliases in its
``torch-tokens.index.json`` are reported and pruned.

Plans are built on ``--device`` (default ``cuda``, which needs a card;
``--device cpu`` runs everywhere) with ``--backend`` (``auto``, ``cuda``
or ``torch``), at tile 16 and group 2, as the JAX package's CLI. Nothing
is executed: the plans' constants are staged on the device, which the
launch check reads back. Exit status is nonzero if any verification, lint, or
audit fails.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

__all__ = ["check_matrix", "lock_lint", "main"]


def _operands(name: str, scale: float):
    from repro_torch.sparse.formats import COO
    from repro_torch.sparse.random import suite_matrix

    a = suite_matrix(name, scale=scale).to_coo().sum_duplicates()
    b = COO(a.col, a.row, a.val, (a.shape[1], a.shape[0]))
    return a, b


def _verify_one(plan, label: str, failures: list):
    """Print and return the plan's report: the one its ``validate="deep"``
    build just kept (``plan.report.verify_report``), else a fresh
    :func:`verify_plan`; plus the launch lint."""
    from repro_torch.analysis.kernel_lint import lint_plan_kernel_specs
    from repro_torch.analysis.verify import verify_plan

    rep = plan.report.verify_report or verify_plan(plan)
    lint = lint_plan_kernel_specs(plan)
    bad = [f for f in lint if f.severity == "error"]
    ok = rep.ok and not bad
    print(f"  {label:<28} "
          f"{'ok' if ok else 'FAILED':<7} "
          f"({len(rep.checks_run)} checks, {rep.elapsed_s * 1e3:6.1f} ms, "
          f"t={plan.report.num_triples}, nnz_c={plan.assembly.nnz})", flush=True)
    for f in rep.findings + lint:
        print(f"    {f}")
    if not ok:
        failures.append(f"{label}: verification failed")
    return rep


def check_matrix(name: str, scale: float, shards: int, backend: str, failures: list, *,
                 device="cuda", tile: int = 16, group: int = 2, store_dir=None) -> dict:
    """Build and verify the element, block, sharded (``shards > 1``) and
    rehydrated plans of one paper matrix; append failures. Returns
    ``{label: (plan, VerifyReport)}``. ``store_dir`` is the disk tier's
    directory (default: a temporary one, removed on return)."""
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo
    from repro_torch.spgemm import PlanCache, spgemm_plan

    print(f"\n== {name} (scale={scale}) " + "=" * max(1, 40 - len(name)), flush=True)
    a, b = _operands(name, scale)
    out = {}
    store = (tempfile.TemporaryDirectory() if store_dir is None
             else contextlib.nullcontext(str(store_dir)))
    with store as root:
        cache = PlanCache(disk_dir=root)
        kw = dict(backend=backend, device=device, cache=cache, validate="deep")
        plan = spgemm_plan(a, b, tile=tile, group=group, **kw)
        out["element"] = (plan, _verify_one(plan, "element", failures))
        a_bcsv, _ = bcsv_from_coo(a, (tile, tile), group)
        b_bcsr, _ = bcsr_from_coo(b, (tile, tile))
        bplan = spgemm_plan(a_bcsv, b_bcsr, **kw)
        out["block"] = (bplan, _verify_one(bplan, "block", failures))
        if shards > 1:
            mesh = make_shard_mesh(shards, devices=[device] * shards)
            splan = spgemm_plan(a, b, tile=tile, group=group, mesh=mesh, **kw)
            label = f"sharded x{shards}"
            out[label] = (splan, _verify_one(splan, label, failures))
        # Warm restart: a fresh cache over the same store directory must
        # rehydrate from disk (no symbolic rebuild) and still verify.
        kw["cache"] = PlanCache(disk_dir=root)
        rplan = spgemm_plan(a, b, tile=tile, group=group, **kw)
        if rplan.report.load_hits < 1:
            failures.append(f"{name}: rehydrated plan did not load from disk")
        out["rehydrated"] = (rplan, _verify_one(rplan, "rehydrated", failures))
    return out


def lock_lint(failures: list, *, backend: str = "auto", device="cuda") -> dict:
    """Scripted serving workload under lock instrumentation; returns
    ``{"sites": n, "edges": {src: [dst, ...]}, "findings": [...]}``.

    Multi-pattern by design: with a single registered pattern the
    dispatcher only ever interleaves one pipeline's locks with the
    gateway's, so the cross-pattern edges (dispatcher draining pattern
    p0 while the collector retires pattern p1, both touching the shared
    queue/stats locks) never enter the acquisition graph. Three patterns
    submitted concurrently from separate threads — at ``max_pipelines=2``
    so at least one pair *must* contend for a pipeline slot — exercise
    exactly those edges before ``mon.check()`` looks for cycles.
    """
    import threading

    import numpy as np

    from repro_torch.analysis.locks import LockOrderError, instrument_spgemm_locks

    print("\n== lock-order lint " + "=" * 40, flush=True)
    with instrument_spgemm_locks() as mon:
        # Locks are created at object construction, so the stack is
        # built fresh inside the instrumented scope.
        from repro_torch.spgemm import PlanCache
        from repro_torch.spgemm.gateway import Outcome, SpGEMMGateway

        specs = [
            ("lint/p0", _operands("poisson3Da", 0.01)),
            ("lint/p1", _operands("2cubes_sphere", 0.002)),
            ("lint/p2", _operands("scircuit", 0.002)),
        ]
        gw = SpGEMMGateway(cache=PlanCache(), max_pipelines=2, depth=2, max_batch=4)
        try:
            plans = {
                name: gw.register(name, a, b, tile=16, group=2, backend=backend,
                                  device=device)
                for name, (a, b) in specs
            }
            tickets: list = []
            tickets_lock = threading.Lock()

            def drive(name: str, seed: int) -> None:
                wa, wb = plans[name].value_shapes()
                rng = np.random.default_rng(seed)
                for _ in range(4):
                    t = gw.submit(
                        name,
                        rng.standard_normal(wa).astype(np.float32),
                        rng.standard_normal(wb).astype(np.float32),
                    )
                    with tickets_lock:
                        tickets.append(t)

            threads = [
                threading.Thread(target=drive, args=(name, i))
                for i, (name, _) in enumerate(specs)
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            results = [t.wait(timeout=120) for t in tickets]
        finally:
            gw.close()
    bad = [r for r in results if r.outcome is not Outcome.OK]
    if bad:
        failures.append(f"lock lint: {len(bad)} of {len(results)} requests failed: "
                        f"{bad[0].outcome}")
    edges = mon.edges()
    n_edges = sum(len(v) for v in edges.values())
    print(f"  {len(mon.sites())} lock sites, {n_edges} ordered edges, "
          f"{len(results)} requests")
    for src in sorted(edges):
        print(f"    {src} -> {', '.join(sorted(edges[src]))}")
    info = {"sites": len(mon.sites()), "edges": {k: sorted(v) for k, v in edges.items()},
            "requests": len(results), "findings": []}
    try:
        warnings = mon.check()
    except LockOrderError as e:
        failures.append(f"lock-order cycle: {e}")
        print(f"  FAILED: {e}")
        info["findings"] = [str(f) for f in mon.findings()]
        return info
    for w in warnings:
        print(f"    {w}")
    info["findings"] = [str(w) for w in warnings]
    print("  acyclic: ok")
    return info


def _audit_store(root: str, failures: list) -> None:
    from repro_torch.spgemm.persist import PlanStore

    print(f"\n== store audit: {root} " + "=" * 20)
    store = PlanStore(root)
    report = store.audit()
    print(f"  {report['files']} artifact file(s), {report['aliases']} "
          f"alias(es), {len(report['orphaned'])} orphaned "
          f"(pruned={report['pruned']})")
    for tok in report["orphaned"]:
        print(f"    orphaned alias: {tok}")
    # Orphans are pruned, not fatal — a second audit must come back clean.
    if store.audit()["orphaned"]:
        failures.append("store audit: orphaned aliases survived pruning")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--paper-matrices", action="store_true",
                    help="verify plans for every paper matrix")
    ap.add_argument("--matrices", default=None,
                    help="comma-separated matrix subset (default: all)")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="suite_matrix scale (default 0.01: CI-sized)")
    ap.add_argument("--shards", type=int, default=0,
                    help="also verify a plan sharded N ways over the device")
    ap.add_argument("--backend", default="auto", choices=("auto", "cuda", "torch"),
                    help="plan backend (default auto: cuda on a CUDA device)")
    ap.add_argument("--device", default="cuda",
                    help="device the plans are built on (default cuda; cpu runs anywhere)")
    ap.add_argument("--lock-lint", action="store_true",
                    help="run the gateway/pipeline lock-order lint")
    ap.add_argument("--store", default=None,
                    help="audit this PlanStore directory (default: "
                         "$REPRO_TORCH_SPGEMM_PLAN_DIR when set)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    failures: list = []
    ran = False
    if args.paper_matrices or args.matrices:
        ran = True
        from repro_torch.analysis.kernel_lint import lint_kernel_module
        from repro_torch.configs.paper_matrices import SUITE

        print("== kernel module lint " + "=" * 38)
        mod_findings = lint_kernel_module()
        for f in mod_findings:
            print(f"  {f}")
            if f.severity == "error":
                failures.append(f"kernel lint: {f.message}")
        if not mod_findings:
            print("  ok (launch geometry + fp32 accumulation + shared-memory mirror)")
        names = (args.matrices.split(",") if args.matrices
                 else list(SUITE))
        for name in names:
            check_matrix(name.strip(), args.scale, args.shards, args.backend, failures,
                         device=args.device)
    if args.lock_lint:
        ran = True
        lock_lint(failures, backend=args.backend, device=args.device)
    from repro_torch.spgemm.persist import PLAN_DIR_ENV

    store_dir = args.store or os.environ.get(PLAN_DIR_ENV)
    if store_dir and os.path.isdir(store_dir):
        ran = True
        _audit_store(store_dir, failures)
    if not ran:
        ap.error("nothing to do: pass --paper-matrices, --matrices, "
                 "--lock-lint, and/or --store")
    dt = time.perf_counter() - t0
    if failures:
        print(f"\nFAILED ({len(failures)} problem(s), {dt:.1f}s):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"\nall static checks passed ({dt:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
