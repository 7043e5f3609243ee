"""Fault-tolerant training loop.

The port of ``repro.runtime.trainer``. It composes the substrate into the
loop a cluster job actually runs:

* **auto-resume** — on start, restores the newest intact checkpoint;
* **SIGTERM/SIGINT safety** — preemption signals set a flag; the loop
  checkpoints at the next step boundary and exits cleanly;
* **periodic + async checkpoints** — snapshot every ``ckpt_every`` steps
  without stalling the step loop;
* **straggler watchdog** — EMA z-score step-time detector with a hook;
* **heartbeats** — liveness files for an external supervisor.

Where the reference blocks on the loss (``jax.block_until_ready``), the
port waits for the loss's device (``torch.cuda.synchronize``; a CPU step
has finished when it returns), so that step times are device times.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.heartbeat import Heartbeat
from repro_torch.runtime.straggler import StragglerDetector

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10
    install_signal_handlers: bool = True
    heartbeat: bool = True


def _wait(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Trainer:
    def __init__(
        self,
        tc: TrainerConfig,
        train_step: Callable,  # (params, opt_state, batch) -> (p, s, metrics)
        batches: Iterator[Dict],
        params: Any,
        opt_state: Any,
        on_metrics: Optional[Callable[[int, Dict], None]] = None,
    ):
        self.tc = tc
        self.train_step = train_step
        self.batches = batches
        self.params = params
        self.opt_state = opt_state
        self.on_metrics = on_metrics
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep)
        self.detector = StragglerDetector()
        self.hb = Heartbeat(tc.ckpt_dir) if tc.heartbeat else None
        self.step = 0
        self._preempted = False
        self.history: list = []

    # -- fault-tolerance plumbing ----------------------------------------
    def _handle_signal(self, signum, frame):  # pragma: no cover - signal path
        self._preempted = True

    def _maybe_resume(self) -> None:
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        state = {"params": self.params, "opt": self.opt_state}
        restored = self.ckpt.restore(latest, state)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = latest
        print(f"[trainer] resumed from checkpoint step {latest}")

    def _save(self, blocking: bool) -> None:
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            blocking=blocking,
        )

    # -- the loop -----------------------------------------------------------
    def run(self) -> Dict:
        tc = self.tc
        if tc.install_signal_handlers:
            try:
                signal.signal(signal.SIGTERM, self._handle_signal)
                signal.signal(signal.SIGINT, self._handle_signal)
            except ValueError:  # non-main thread (tests)
                pass
        self._maybe_resume()
        if self.hb:
            self.hb.start()
        t_prev = time.perf_counter()
        try:
            while self.step < tc.total_steps and not self._preempted:
                batch = next(self.batches)
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch
                )
                _wait(metrics["loss"])
                self.step += 1
                now = time.perf_counter()
                self.detector.observe(self.step, now - t_prev)
                t_prev = now
                if self.hb:
                    self.hb.step = self.step
                if self.step % tc.log_every == 0 or self.step == tc.total_steps:
                    rec = {k: float(v) for k, v in metrics.items()}
                    rec["step"] = self.step
                    self.history.append(rec)
                    if self.on_metrics:
                        self.on_metrics(self.step, rec)
                if self.step % tc.ckpt_every == 0:
                    self._save(blocking=not tc.ckpt_async)
        finally:
            # Preemption / normal exit: make the final state durable.
            self.ckpt.wait()
            self._save(blocking=True)
            if self.hb:
                self.hb.stop()
        return {
            "final_step": self.step,
            "preempted": self._preempted,
            "history": self.history,
            "straggler_events": self.detector.events,
        }
