"""Deterministic synthetic data: LM token batches and the SpGEMM value
stream.

:class:`SyntheticLM` draws LM batches and :class:`SpGEMMValueStream`
fresh values for one fixed sparsity pattern, each as a pure function of
``(seed, step)`` with numpy, so that they give the same arrays as the JAX
package's classes of the same names; :func:`_prefetch_iter` runs the
drawing in a background thread, so it overlaps the device's work.

``batch_specs`` (``ShapeDtypeStruct`` stand-ins for the dry-run) waits
for the dry-run tooling. ``shard_batch`` has no counterpart: it lays the
global batch out on the mesh's data axes, and on one card the caller
moves the batch with ``.to(device)``.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.sparse.formats import COO

__all__ = ["SyntheticLM", "SpGEMMValueStream"]


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


class SyntheticLM:
    """Deterministic synthetic LM batches for a given config.

    The token stream is a mixture of structured sequences (ramps, repeats,
    n-gram chains) so that a tiny model's training visibly reduces the
    loss; pure-uniform tokens have no learnable signal. ``batch_at(step)``
    is bitwise equal to the reference's.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq: int,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def _tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab
        kind = rng.integers(0, 3, b)
        out = np.empty((b, s), np.int32)
        for i in range(b):
            if kind[i] == 0:  # ramp with random stride
                start, stride = rng.integers(0, v), rng.integers(1, 7)
                out[i] = (start + stride * np.arange(s)) % v
            elif kind[i] == 1:  # repeated motif
                mlen = int(rng.integers(2, 17))
                motif = rng.integers(0, v, mlen)
                out[i] = np.tile(motif, s // mlen + 1)[:s]
            else:  # first-order chain: next = (3*prev + c) % v
                c = int(rng.integers(1, v))
                seq = np.empty(s, np.int64)
                seq[0] = rng.integers(0, v)
                for t in range(1, s):
                    seq[t] = (3 * seq[t - 1] + c) % v
                out[i] = seq
        return out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        cfg = self.cfg
        if cfg.frontend == "audio":
            feats = rng.standard_normal(
                (self.batch, self.seq, cfg.frontend_dim)
            ).astype(np.float32)
            labels = rng.integers(0, cfg.vocab, (self.batch, self.seq)).astype(np.int32)
            mask = (rng.random((self.batch, self.seq)) < 0.08).astype(np.float32)
            return {"feats": feats, "labels": labels, "mask": mask}
        if cfg.frontend == "vision":
            s_text = self.seq - cfg.num_patches
            toks = self._tokens(rng, self.batch, s_text + 1)
            feats = rng.standard_normal(
                (self.batch, cfg.num_patches, cfg.frontend_dim)
            ).astype(np.float32)
            return {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
                "feats": feats,
            }
        toks = self._tokens(rng, self.batch, self.seq + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iter(self, start_step: int = 0, prefetch: int = 2) -> Iterator[Dict]:
        """Background-thread prefetching iterator starting at start_step."""
        return _prefetch_iter(self.batch_at, start_step, prefetch)


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
