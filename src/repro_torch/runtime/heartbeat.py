"""Liveness heartbeats + a reusable process-metrics exporter.

Two layers:

* **Metrics** (:class:`MetricsRegistry` and its :class:`Counter` /
  :class:`Gauge` / :class:`Summary` instruments) — a dependency-free,
  thread-safe registry any subsystem can write into.  The serving
  gateway (:mod:`repro_torch.spgemm.gateway`) records per-pattern queue
  depth, batch fill, latency quantiles, throughput, and shed counts here;
  ``registry.snapshot()`` renders everything as one plain dict.
* **Liveness** (:class:`Heartbeat`) — each worker process touches
  ``<dir>/heartbeat_<host>.json`` every ``interval`` seconds from a
  daemon thread; an external supervisor (or the coordinator) declares a
  worker dead after ``timeout`` without a beat and triggers
  restart-from-checkpoint.  ``check_peers`` implements the
  supervisor-side scan.  Passing ``metrics=registry`` embeds a metrics
  snapshot in every beat, which turns the heartbeat file into a cheap
  pull-based metrics export: whatever scrapes liveness scrapes the
  serving metrics too.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Heartbeat",
    "MetricsRegistry",
    "Summary",
    "check_peers",
]


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Summary:
    """Windowed distribution: lifetime count/sum plus quantiles over the
    last ``window`` observations (enough for serving p50/p99 without
    unbounded memory)."""

    __slots__ = ("_lock", "_window", "count", "total")

    def __init__(self, window: int = 2048):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._window.append(v)
            self.count += 1
            self.total += v

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained window (0 when
        empty). ``p`` in [0, 100]."""
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return 0.0
        rank = max(0, min(len(vals) - 1, math.ceil(p / 100.0 * len(vals)) - 1))
        return vals[rank]

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._window)
            count, total = self.count, self.total

        def pct(p: float) -> float:
            if not vals:
                return 0.0
            rank = max(0, min(len(vals) - 1,
                              math.ceil(p / 100.0 * len(vals)) - 1))
            return vals[rank]

        return {
            "count": count,
            "mean": (total / count) if count else 0.0,
            "min": vals[0] if vals else 0.0,
            "max": vals[-1] if vals else 0.0,
            "p50": pct(50.0),
            "p90": pct(90.0),
            "p99": pct(99.0),
        }


class MetricsRegistry:
    """Named instruments, created on first use, rendered by
    :meth:`snapshot`.

    Names are opaque dotted strings (``gateway.<pattern>.latency_s``);
    re-requesting a name returns the same instrument, and requesting an
    existing name as a different instrument type raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(*args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def summary(self, name: str, window: int = 2048) -> Summary:
        return self._get(name, Summary, window)

    def snapshot(self) -> dict:
        """Every instrument's current value as a plain (JSON-serializable)
        dict: counters/gauges flatten to numbers, summaries to their
        quantile dicts."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            out[name] = m.snapshot() if isinstance(m, Summary) else m.value
        return out


class Heartbeat:
    def __init__(self, directory: str, host: str = "host0",
                 interval: float = 5.0,
                 metrics: Optional[MetricsRegistry] = None):
        self.path = os.path.join(directory, f"heartbeat_{host}.json")
        self.interval = interval
        self.host = host
        self.metrics = metrics
        os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.step = 0

    def beat(self) -> None:
        rec = {"host": self.host, "time": time.time(), "step": self.step}
        if self.metrics is not None:
            rec["metrics"] = self.metrics.snapshot()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("heartbeat already running; stop() it first")
        # A fresh event per start: stop() leaves the old event set, and a
        # restarted thread waiting on it would exit immediately without
        # ever beating again.
        self._stop = threading.Event()
        stop = self._stop

        def run():
            while not stop.wait(self.interval):
                self.beat()

        self.beat()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join()
            self._thread = None


def check_peers(directory: str, timeout: float) -> Dict[str, List[str]]:
    """Supervisor scan: classify workers as alive/dead by beat age."""
    now = time.time()
    alive, dead = [], []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if not name.startswith("heartbeat_") or name.endswith(".tmp"):
                continue
            try:
                with open(os.path.join(directory, name)) as f:
                    rec = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue
            (alive if now - rec["time"] <= timeout else dead).append(rec["host"])
    return {"alive": sorted(alive), "dead": sorted(dead)}
