"""A closed loop: one client that sends its next request when the last one
has returned, for the window's seconds. The traffic's ``sample`` results,
drawn from the seed, are kept for the comparison with the reference."""
from __future__ import annotations

import time

from perfbench.loops import Request, Reservoir


def run(entry, traffic: dict, seconds: float, seed: int):
    """Call ``entry.call(i)`` back to back while fewer than ``seconds`` have
    passed since the first call started. The window runs from the first
    call's start to the last call's end."""
    sample = Reservoir(int(traffic["sample"]), seed)
    reqs = []
    t0 = time.perf_counter()
    i = 0
    while True:
        sent = time.perf_counter()
        if sent - t0 >= seconds:
            break
        r = Request(i, entry.product(i), sent, sent)
        try:
            out = entry.call(i)
        except Exception as e:  # a failed request is counted, not fatal
            r.outcome = f"error: {e!r}"[:300]
            out = None
        r.done = time.perf_counter()
        if out is not None:
            r.ok, r.outcome = True, "ok"
            sample.offer(i, out)
        reqs.append(r)
        i += 1
    t1 = reqs[-1].done if reqs else t0
    return reqs, dict(sample.items), t0, t1
