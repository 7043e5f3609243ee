"""Arithmetic the metric readers share. A reader returns ``None`` where its
run holds nothing to read, and the metric is then left out of the line."""
from __future__ import annotations


def least_total_s(run):
    """The least chip time of the completed requests, summed (``None`` on a
    card without peaks in the table)."""
    least = [s for r, s in zip(run.requests, run.least_s) if r.ok]
    if not least or any(s is None for s in least):
        return None
    return sum(least)


def kernels_roofline(run):
    """Least chip time of the completed products over the device time of
    every operation on the card that is not a copy or a memset."""
    if run.trace is None:
        return None
    least, kernels = least_total_s(run), run.trace.total(copies=False)
    if least is None or kernels <= 0:
        return None
    return 100.0 * least / kernels


def device_idle_pct(run):
    """Share of the traced window in which no kernel and no copy ran on
    any stream."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def request_mfu_pct(run):
    """Least chip time of the products completed in the window over the
    window's length."""
    least = least_total_s(run)
    if least is None or run.window_s <= 0:
        return None
    return 100.0 * least / run.window_s
