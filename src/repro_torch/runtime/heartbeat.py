"""Liveness heartbeats, a reusable process-metrics exporter, and spans.

Three layers:

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
* **Spans** (:func:`span`, :class:`SpanRecorder`) — named, nested host
  intervals inside the program (the SpGEMM numeric front and symbolic
  phase), recorded only while tracing is on: while a torch profiler
  records on the calling thread, or after :func:`set_tracing` ``(True)``.
  Off, a span costs one flag check. On, it also enters a torch profiler
  record function, so it shows in the profiler's host timeline, and
  appends a :class:`SpanRecord` stamped on
  ``time.perf_counter_ns`` to a bounded in-memory buffer;
  :func:`totals` sums a window of it per span name. The quantities the
  spans count (bytes copied each way) also go to counters of the
  process-level :func:`default_registry`, always, so a
  :class:`Heartbeat` exports them.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

__all__ = [
    "Counter",
    "Gauge",
    "Heartbeat",
    "MetricsRegistry",
    "SpanRecord",
    "SpanRecorder",
    "Summary",
    "check_peers",
    "default_recorder",
    "default_registry",
    "set_tracing",
    "span",
    "spans",
    "totals",
    "traced",
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


_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-level registry: the program's own counters
    (``spgemm.h2d_bytes``, ``spgemm.d2h_bytes``, and
    ``spgemm.d2h_pinned_bytes``, the part of the downloads copied into
    page-locked memory), for a :class:`Heartbeat` to export."""
    return _REGISTRY


# -- spans ---------------------------------------------------------------------

SPAN_CAPACITY = 1 << 20


class SpanRecord(NamedTuple):
    """One finished span. Times are ``time.perf_counter_ns()``; ``parent``
    is 0 for a root, and ``root`` is the root's id, which every span of
    one request (one ``execute``, one ``spgemm_plan``) shares."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    root: int
    counts: Optional[dict]


class SpanRecorder:
    """A bounded buffer of :class:`SpanRecord` s (``capacity`` records; a
    span the full buffer cannot take is counted in ``dropped``, never
    waited for), and the clock anchor that puts them on the profiler's
    clock."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.forced = False  # set_tracing(True)
        self.dropped = 0
        # (perf_counter_ns, time_ns), taken when the first record enters
        # an empty buffer: the profiler stamps host events on the Unix
        # clock, the program's spans on perf_counter.
        self.anchor: Optional[tuple] = None
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._records: List[SpanRecord] = []

    def clear(self) -> None:
        """Drop every record, the count of dropped spans and the anchor."""
        with self._lock:
            self._records = []
            self.dropped = 0
            self.anchor = None

    def add(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._records) >= self.capacity:
                self.dropped += 1
                return
            if self.anchor is None:
                self.anchor = (time.perf_counter_ns(), time.time_ns())
            self._records.append(rec)

    def profiler_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` time on the profiler's (Unix) clock,
        through the anchor."""
        pc, wall = self.anchor
        return perf_ns - pc + wall

    def spans(self, t0: Optional[float] = None, t1: Optional[float] = None) -> List[SpanRecord]:
        """The records whose interval lies in ``[t0, t1]``, seconds on the
        ``time.perf_counter`` clock (an open end where ``None``)."""
        lo = -1 if t0 is None else round(t0 * 1e9)
        hi = float("inf") if t1 is None else round(t1 * 1e9)
        with self._lock:
            recs = list(self._records)
        return [r for r in recs if r.start_ns >= lo and r.end_ns <= hi]

    def totals(self, t0: Optional[float] = None, t1: Optional[float] = None) -> dict:
        """Per span name in the window: ``count``, ``seconds``,
        ``self_seconds`` (each span's duration less the part its child
        spans cover) and ``counts`` summed; and ``dropped``."""
        recs = self.spans(t0, t1)
        ids = {r.id for r in recs}
        children: Dict[int, list] = {}
        for r in recs:
            if r.parent in ids:
                children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
        sums: Dict[str, dict] = {}
        for r in recs:
            t = sums.setdefault(r.name, {"count": 0, "ns": 0, "self_ns": 0, "counts": {}})
            t["count"] += 1
            t["ns"] += r.end_ns - r.start_ns
            t["self_ns"] += r.end_ns - r.start_ns - _covered(children.get(r.id, ()))
            for k, v in (r.counts or {}).items():
                t["counts"][k] = t["counts"].get(k, 0) + v
        out = {name: {"count": t["count"], "seconds": t["ns"] / 1e9,
                      "self_seconds": t["self_ns"] / 1e9, "counts": t["counts"]}
               for name, t in sums.items()}
        return {"spans": out, "dropped": self.dropped}


def _covered(intervals) -> int:
    """Nanoseconds that the union of ``intervals`` covers."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


_RECORDER = SpanRecorder()
# The innermost open span of this thread or task: (id, root id).
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_span", default=None)
# The record function a span enters: torch's fast one where this torch has
# it, else ``record_function``. Under a profiler ``record_function`` takes
# tens of microseconds to enter and to leave, and the profiler's own stamps
# fall at varying points inside that time, so a short span's duration in
# the buffer and in the profiler would differ by it; the fast one takes
# about a microsecond.
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
# Whether a torch profiler records on this thread (per thread, as the
# profiler's own host events are).
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """What :func:`span` gives while tracing is off: a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "_id", "_parent", "_root", "_token", "_rf", "_start")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts or None

    def count(self, **counts) -> None:
        """Attach ``counts`` known only once the span's work is done."""
        self.counts = {**(self.counts or {}), **counts}

    def __enter__(self):
        parent = _CURRENT.get()
        self._id = next(_RECORDER._ids)
        self._parent, self._root = parent if parent is not None else (0, self._id)
        self._token = _CURRENT.set((self._id, self._root))
        # Stamped after the profiler's enter and after its exit, as the
        # profiler stamps its own event late in each.
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        _CURRENT.reset(self._token)
        _RECORDER.add(SpanRecord(self.name, self._start, end, self._id, self._parent,
                                 self._root, self.counts))
        return False


def span(name: str, **counts):
    """A context manager timing a named stage of the program, with
    ``counts`` (e.g. ``bytes``) attached; ``with span(...) as s`` gives
    ``s.count(**counts)`` for counts known only inside. Off, it is a no-op
    after one flag check; on, see the module docstring."""
    if not (_RECORDER.forced or _profiler_enabled()):
        return _OFF
    return _Span(name, counts)


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def set_tracing(on: bool) -> None:
    """Turn tracing on or off for every thread, with or without a
    profiler (a running profiler turns it on for its own thread)."""
    _RECORDER.forced = bool(on)


def default_recorder() -> SpanRecorder:
    """The process-level buffer every :func:`span` records into."""
    return _RECORDER


def spans(t0: Optional[float] = None, t1: Optional[float] = None) -> List[SpanRecord]:
    """:meth:`SpanRecorder.spans` of the process-level recorder."""
    return _RECORDER.spans(t0, t1)


def totals(t0: Optional[float] = None, t1: Optional[float] = None) -> dict:
    """:meth:`SpanRecorder.totals` of the process-level recorder."""
    return _RECORDER.totals(t0, t1)


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
