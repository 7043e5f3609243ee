"""How the benchmark offers load. A traffic mix's ``loop`` names the module
``perfbench/loops/<loop>.py`` that runs its window, through
``run(entry, traffic, seconds, seed) -> (requests, kept, t0, t1)``: every
request with its times and outcome, the sample of results kept for the
comparison with the reference (a dict by request index), and the window's
ends on the host's clock.

Every request is timed on the host's clock from its due time to its result
on the host; in a closed loop a request is due when it is sent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    product: str
    due: float
    sent: float
    done: Optional[float] = None  # None: never returned
    ok: bool = False  # returned a result (not shed, not failed)
    outcome: str = "pending"

    @property
    def latency(self) -> float:
        """Due time to result; +inf for a request without a result."""
        return self.done - self.due if self.ok and self.done is not None else float("inf")


class Reservoir:
    """A uniform sample of ``k`` results of a stream of unknown length,
    drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng((seed, 0x5A11))
        self.items: list = []
        self.seen = 0

    def offer(self, key, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((key, item))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = (key, item)
