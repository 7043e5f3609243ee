"""The program's own spans, read per completed request.

``repro_torch.runtime.heartbeat`` records a span around each stage of the
SpGEMM numeric front (``spgemm.execute.*``) and of the symbolic phase
(``spgemm.plan.*``) while a torch profiler records, that is, in a run with
``--trace 1``. A reader here sums the spans that lie inside the run's
window, on the same ``time.perf_counter`` clock as the window's ends, and
divides by the requests completed in it. A program that records no spans
gives ``None``, and the metric is left out of the line.
"""
from __future__ import annotations


def per_request(run, name: str, count=None, scale: float = 1e3):
    """``scale`` times the summed seconds of span ``name`` in the window
    (or, with ``count``, its summed count of that name) per completed
    request; ``None`` where the program has no span recorder, the window
    holds no such span, or the recorder dropped any span."""
    try:
        from repro_torch.runtime.heartbeat import totals
    except ImportError:
        return None
    done = sum(1 for r in run.requests if r.ok)
    got = totals(run.t0, run.t1)
    s = got["spans"].get(name)
    if not done or s is None or got["dropped"]:
        return None
    value = s["seconds"] if count is None else s["counts"].get(count)
    return None if value is None else scale * value / done
