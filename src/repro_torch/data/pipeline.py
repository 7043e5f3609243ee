"""Deterministic SpGEMM value stream (the serving-shaped input side).

:class:`SpGEMMValueStream` draws fresh values for one fixed sparsity
pattern at every step, as a pure function of ``(seed, step)`` with numpy,
so that it gives the same arrays as the JAX package's stream of the same
name; :func:`_prefetch_iter` runs the drawing in a background thread, so
it overlaps the pipeline's device work. The LM token pipeline
(``SyntheticLM``, ``batch_specs``, ``shard_batch``) belongs to the
training slice and is not ported.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.sparse.formats import COO

__all__ = ["SpGEMMValueStream"]


def _prefetch_iter(batch_at, start_step: int, prefetch: int) -> Iterator[Dict]:
    """Background-thread prefetching iterator over ``batch_at(step)``.

    The producer uses a timed ``put`` so it re-checks the stop flag even
    while the queue is full — dropping the iterator can never leak a
    thread blocked in ``q.put``. A ``batch_at`` failure is forwarded and
    re-raised in the consumer instead of silently killing the producer
    (which would deadlock the consumer in ``q.get``).
    """
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        step = start_step
        try:
            while not stop.is_set():
                if not _put(("batch", batch_at(step))):
                    return
                step += 1
        except BaseException as e:  # forward to the consumer
            _put(("error", e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "error":
                raise payload
            yield payload
    finally:
        stop.set()


class SpGEMMValueStream:
    """Serving-shaped SpGEMM workload: one fixed sparsity pattern, fresh
    values every step.

    This is the input side of the plan/execute split
    (:mod:`repro_torch.spgemm`): the pattern is fixed at construction — exactly
    what a cached :class:`~repro_torch.spgemm.plan.SpGEMMPlan` amortizes over —
    and ``values_at(step)`` is a pure function of ``(seed, step)``, so the
    stream is deterministic by step: a restart resumes at any step with no
    state file.

    ``integer_values=True`` draws small integers (exact in float32 under
    any accumulation order) so results can be compared bit-for-bit against
    the ``spgemm_gustavson`` oracle.

    ``batch`` switches the stream to batch mode — the input side of
    ``SpGEMMPlan.execute_batch``: ``values_batch_at(step)`` stacks ``batch``
    consecutive single-step value sets into ``[batch, nnz]`` arrays, with
    element ``i`` of batch-step ``s`` equal to ``values_at(s * batch + i)``,
    so batched serving consumes exactly the single-stream sequence.
    """

    def __init__(
        self,
        a_pattern: COO,
        b_pattern: COO,
        seed: int = 0,
        integer_values: bool = False,
        batch: Optional[int] = None,
    ):
        if a_pattern.shape[1] != b_pattern.shape[0]:
            raise ValueError(
                f"inner dims mismatch: {a_pattern.shape} x {b_pattern.shape}"
            )
        if batch is not None and batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.a_pattern = a_pattern
        self.b_pattern = b_pattern
        self.seed = seed
        self.integer_values = integer_values
        self.batch = batch

    def _vals(self, rng: np.random.Generator, nnz: int) -> np.ndarray:
        if self.integer_values:
            v = rng.integers(-4, 5, nnz).astype(np.float32)
            return np.where(v == 0, np.float32(1.0), v)
        return rng.standard_normal(nnz).astype(np.float32)

    def values_at(self, step: int):
        """Fresh ``(a_vals, b_vals)`` for this step, aligned with the
        patterns' canonical coordinate order."""
        rng = np.random.default_rng((self.seed, step))
        return (
            self._vals(rng, self.a_pattern.nnz),
            self._vals(rng, self.b_pattern.nnz),
        )

    def values_batch_at(self, step: int, batch: Optional[int] = None):
        """Stacked ``(a_vals[batch, nnz_a], b_vals[batch, nnz_b])`` for
        batch-step ``step`` — row ``i`` is ``values_at(step * batch + i)``.

        ``batch`` overrides the stream's constructed batch size."""
        b = self.batch if batch is None else batch
        if b is None:
            raise ValueError(
                "no batch size: construct with batch=... or pass batch"
            )
        a_out = np.empty((b, self.a_pattern.nnz), np.float32)
        b_out = np.empty((b, self.b_pattern.nnz), np.float32)
        for i in range(b):
            a_out[i], b_out[i] = self.values_at(step * b + i)
        return a_out, b_out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Single-step value dict, or stacked ``[batch, nnz]`` arrays when
        the stream was constructed in batch mode."""
        if self.batch is not None:
            a_vals, b_vals = self.values_batch_at(step)
        else:
            a_vals, b_vals = self.values_at(step)
        return {"a_vals": a_vals, "b_vals": b_vals}

    def iter(self, start_step: int = 0, prefetch: int = 2) -> Iterator[Dict]:
        """Background-thread prefetching iterator over :meth:`batch_at`,
        starting at ``start_step``."""
        return _prefetch_iter(self.batch_at, start_step, prefetch)

    def value_iter(
        self,
        start_step: int = 0,
        steps: Optional[int] = None,
        prefetch: int = 2,
    ) -> Iterator[tuple]:
        """``(a_vals, b_vals)`` tuples, prefetched — the feed side of
        ``SpGEMMPlan.execute_stream`` / ``SpGEMMPipeline.stream``.

        Value generation runs in the prefetch thread, so it overlaps the
        pipeline's device compute like every other stage. ``steps=N``
        makes the iterator finite (the stream drains after N results);
        ``steps=None`` streams forever. In batch mode each item is a
        stacked ``[batch, nnz]`` pair (one pipelined ``execute_batch``
        step)."""
        it = self.iter(start_step, prefetch)
        try:
            n = 0
            while steps is None or n < steps:
                d = next(it)
                yield d["a_vals"], d["b_vals"]
                n += 1
        finally:
            it.close()
