"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (imports, the kernels' build on a checkout's first run,
inputs from the seed, the program's set-up and warm-up) is timed from the
process's start to the first timed request; then the cell's traffic runs
for ``--seconds``; then the program's state is freed and a sample of its
results is compared with the plain reference. ``--trace 1`` records the
window under torch.profiler and reports the per-layer metrics instead of
the end-to-end ones. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """Import the benchmark and the port from this checkout, and keep
    every build and kernel cache inside it at a fixed path."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class RunRecord:
    """What a run measured, for the metric readers: ``setup_s``; the window
    (``t0``, ``t1``, ``window_s``); ``requests`` (``perfbench.loops.Request``);
    ``least_s`` (per request, or ``None``); ``counters`` (the program's,
    differenced over the window); ``spans`` (the harness's host-clock
    spans around calls into the program, seconds); ``trace`` (a
    ``perfbench.trace.TraceSummary``, or ``None``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.window_s = self.t1 - self.t0


def run_cell(manifest, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, config=None, traffic=None):
    """Set up, run the window, free the program, check. Returns the run's
    record, the numbers compared with their limits, how many results were
    compared, and the device's memory peak. ``config`` and ``traffic``
    replace what the manifest names (the tests cut them to a small size)."""
    import torch

    from perfbench import manifest as mf
    from perfbench.trace import Trace

    config = config or manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    sut = mf.entry(config["system"], traffic["entry"])(config, traffic, seed, device)
    tracer = Trace(trace)
    with tracer:
        before = sut.counters()
        with tracer.window():
            reqs, kept, t0, t1 = mf.loop(traffic["loop"]).run(sut, traffic, seconds, seed)
        after = sut.counters()
    peak = torch.cuda.max_memory_allocated(device) if str(device).startswith("cuda") else 0
    counters = {k: after[k] - before.get(k, 0) for k in after}
    extra = sut.extra_checks(counters, reqs)
    sut.release()
    numbers, compared = sut.check(kept)
    del kept
    numbers["unanswered"] = sum(1 for r in reqs if not r.ok)
    numbers.update(extra)
    limits = config.get("limits", {})
    checks = {k: {"value": v, "limit": float(limits.get(k, 0))} for k, v in numbers.items()}
    record = RunRecord(
        setup_s=t0 - t_start, t0=t0, t1=t1, requests=reqs, counters=counters,
        spans=sut.spans, trace=tracer.summary,
        least_s=[sut.least_seconds(r.index) for r in reqs])
    return record, checks, compared, peak


def correct(checks: dict) -> bool:
    """A run is correct when every number compared is within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def metrics(manifest, cell: str, record: RunRecord, trace: bool) -> dict:
    """Each of the cell's metrics that its reader finds something for."""
    out = {}
    for m in manifest.metrics(cell, trace):
        value = manifest.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from perfbench import manifest as mf

    manifest = mf.Manifest(ROOT)
    cell = manifest.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    record, checks, compared, peak = run_cell(
        manifest, cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = mf.forbidden_modules(sys.modules)
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    result = {
        "correct": correct(checks),
        "attempted": len(record.requests),
        "failed": sum(1 for r in record.requests if not r.ok),
        "metrics": metrics(manifest, args.workload, record, bool(args.trace)),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)},
    }
    if record.trace is not None:
        result["device"].update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = checks
    log(f"counters over the window: {json.dumps(record.counters)}")
    log(f"results compared with the reference: {compared}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
