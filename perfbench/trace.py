"""The device trace of a run's window, read from torch.profiler.

``Trace`` records the window under the profiler (host operations of every
thread, and every kernel, copy and memset on the card) and reduces it:
the union of device activity over all streams (busy), device time by
operation, copies apart from kernels, and the idle gaps of the card named
by what the host was doing in them. The union over streams is the method
of ``chip_smoke.py``'s ``device_union_ms``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

WINDOW = "perfbench.window"
COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 96
# Idle gaps whose host activity is looked up, longest first.
GAPS_NAMED = 512


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: dict  # operation name -> device seconds in the window
    idle_gaps: list  # [[host activity, seconds], ...], longest first

    def total(self, match=None, copies=None) -> float:
        """Device seconds of the operations whose name starts with
        ``match`` (any name when None), of copies only (``copies=True``),
        or of everything but copies (``copies=False``)."""
        out = 0.0
        for name, s in self.device_s.items():
            is_copy = name.startswith(COPY_PREFIXES)
            if copies is not None and is_copy != copies:
                continue
            if match is not None and not name.startswith(match):
                continue
            out += s
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": self.idle_gaps[:10]}


def union(starts: np.ndarray, ends: np.ndarray):
    """Merged ``[start, end)`` intervals of the given ones, in order."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.empty(s.shape[0], dtype=bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.shape[0] - 1)
    return s[first], e[last]


def _events(prof):
    """``(name, is_device, start_ns, end_ns)`` of every recorded event. A
    host annotation (``record_function``) is mirrored on the device's
    timeline as a span that covers the work it launched; such spans are
    not device work and are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and (e.name().startswith("perfbench.") or _annotation(e)):
            continue
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def _annotation(e) -> bool:
    """Whether a kineto event is a user annotation (the accessor differs
    between torch versions)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def summarize(events, window_name: str = WINDOW) -> TraceSummary:
    """Reduce ``(name, is_device, start_ns, end_ns)`` events to the window
    that the host event ``window_name`` spans."""
    marks = [(s, e) for name, dev, s, e in events if not dev and name == window_name]
    if not marks:
        raise RuntimeError(f"the trace holds no {window_name!r} span")
    w0, w1 = marks[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events if d and e > w0 and s < w1]
    host = [(n, s, e) for n, d, s, e in events if not d and n != window_name]
    device_s: dict = {}
    for n, s, e in dev:
        device_s[n] = device_s.get(n, 0.0) + (e - s) / 1e9
    starts = np.array([s for _, s, _ in dev], dtype=np.int64)
    ends = np.array([e for _, _, e in dev], dtype=np.int64)
    us, ue = union(starts, ends)
    busy_s = float((ue - us).sum()) / 1e9
    # Gaps: before the first, between, and after the last busy interval.
    g0 = np.concatenate([[w0], ue])
    g1 = np.concatenate([us, [w1]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_s, device_s=device_s,
        idle_gaps=_name_gaps(g0, g1, host))


def _name_gaps(g0, g1, host) -> list:
    """The longest gaps, summed by the innermost host event that covers at
    least half of each ("idle, no host op" where none does)."""
    if g0.size == 0:
        return []
    hs = np.array([s for _, s, _ in host], dtype=np.int64)
    he = np.array([e for _, _, e in host], dtype=np.int64)
    names = [n for n, _, _ in host]
    out: dict = {}
    for i in np.argsort(g0 - g1)[:GAPS_NAMED]:
        a, b = int(g0[i]), int(g1[i])
        cover = np.minimum(he, b) - np.maximum(hs, a)
        ok = np.flatnonzero(cover * 2 >= (b - a))
        name = "idle, no host op"
        if ok.size:
            name = names[ok[np.argmin(he[ok] - hs[ok])]][:NAME_CHARS]
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return [[n, s] for n, s in sorted(out.items(), key=lambda kv: -kv[1])]


class Trace:
    """Profile a window: ``with trace.window(): ...`` inside ``with trace:``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def window(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(WINDOW)

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(_events(self._prof))
            self._prof = None
        return False
