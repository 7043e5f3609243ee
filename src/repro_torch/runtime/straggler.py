"""Step-time straggler detection.

The port of ``repro.runtime.straggler``, plain Python with the same logic.
At 1000+ nodes, slow hosts (thermal throttling, failing HBM, noisy
neighbours) stretch every synchronous step. The detector keeps an EMA of
step time and variance; a step whose z-score exceeds the threshold for
``patience`` consecutive steps fires the mitigation hook (in production:
drain + re-slice the mesh; here: a callback + log record, exercised by
tests)."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

__all__ = ["StragglerDetector"]


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1  # EMA coefficient
    z_threshold: float = 3.0
    patience: int = 3
    warmup: int = 5  # steps before detection arms
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _breaches: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record one step time; returns True when mitigation fires."""
        self._n += 1
        if self._n == 1:
            self._mean = dt
            return False
        delta = dt - self._mean
        z = delta / math.sqrt(self._var) if self._var > 0 else 0.0
        fired = False
        if self._n > self.warmup and z > self.z_threshold:
            self._breaches += 1
            if self._breaches >= self.patience:
                fired = True
                self.events.append({"step": step, "dt": dt, "z": z})
                if self.on_straggler:
                    self.on_straggler(step, dt, z)
                self._breaches = 0
        else:
            self._breaches = 0
            # Only fold healthy steps into the baseline.
            self._mean += self.alpha * delta
            self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        return fired
