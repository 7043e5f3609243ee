"""Pipelined SpGEMM serving: submit/collect over the stage-split executor.

FSpGEMM's throughput trick (PAPER Sec. 4) is operand double-buffering:
while one partial product computes, the next rows' operands are already
streaming into on-chip buffers, so the multiply pipeline never stalls on
data movement. The synchronous ``SpGEMMPlan.execute`` is exactly that
stall in host form: rebind, host-to-device copy, kernel, assembly and
device-to-host copy serialized per step. :class:`SpGEMMPipeline` removes
it:

* ``submit(a_vals, b_vals)`` *dispatches* a step (the executor's ``pipe_*``
  protocol: host-to-device copy and value rebind, the scheduled kernel,
  the assembly gather, the device-to-host copy) and returns a
  :class:`SpGEMMTicket` at once. On a CUDA plan each in-flight step owns
  one of the pipeline's ``depth`` CUDA streams, its staged device blocks
  and two page-locked host tensors, one for its input values and one for
  C's values; every copy is asynchronous, so ``submit`` never waits for the
  card and step ``s + 1``'s copies and kernel overlap step ``s``'s: a
  ``depth``-deep operand buffer ring, the paper's double buffer at
  ``depth=2``. A CPU plan (``device="cpu"``) runs the same protocol
  synchronously, with no streams and no pinned memory.
* ``collect(ticket)`` waits for that step's event and returns its CSR
  (the only synchronizing call). Tickets may be collected out of
  submission order; ``collect()`` with no argument takes the oldest.
* in-flight work is bounded by ``depth``: a ``submit`` past the bound
  raises :class:`PipelineFullError` (explicit backpressure), and
  ``stream(value_iter)`` / ``__iter__`` manage the bound for you,
  yielding ordered results.

Results are **bitwise-equal** to sequential ``execute`` calls: the stage
cores are the operations of the fused cores, and submission is stateless
with respect to the plan's staged values (like ``execute_batch``). Each
collected CSR owns its value array (a fresh pinned tensor per step on the
card), so no later step writes into an earlier result.

Error handling: a step whose dispatch fails stores the exception on its
ticket; ``collect`` of that ticket re-raises it while every other
in-flight step stays collectable. While any ticket is in flight the
owning plan refuses buffer teardown (``release_values`` / ``release``
raise): close or drain the pipeline first. ``SpGEMMPipeline`` is a
context manager; exiting discards anything still in flight.
"""
from __future__ import annotations

import threading
import weakref
from typing import Iterable, Iterator, Optional, Tuple, Union

__all__ = [
    "PipelineFullError",
    "SpGEMMPipeline",
    "SpGEMMTicket",
]


class PipelineFullError(RuntimeError):
    """``submit`` past the pipeline's in-flight ``depth`` bound."""


class _Prepared:
    """A validated, host-side-prepared submission (built by
    ``SpGEMMPlan._pipe_check``): execution mode, operands (tensors in the
    plan's value dtypes: pinned host tensors on a CUDA plan, or tensors
    already on the plan's device), batch size (``None`` single-shot), the
    executes-counter increment, and the plan's executor as it stood when
    the submission was checked (``None`` for an empty plan): dispatch and
    collect run on it, never on the plan's attribute, which ``release()``
    clears."""

    __slots__ = ("mode", "a", "b", "batch", "n_execs", "executor")

    def __init__(self, mode, a, b, batch, n_execs, executor):
        self.mode = mode
        self.a = a
        self.b = b
        self.batch = batch
        self.n_execs = n_execs
        self.executor = executor


class _Step:
    """One in-flight pipeline step: its dispatched result (a pending
    device-to-host copy, a list of them for batch submissions, or host
    values on a CPU plan), the stream slot it runs on, or the error its
    dispatch raised. It holds its operands until it is collected."""

    __slots__ = ("prep", "packed", "error", "slot")

    def __init__(self, prep, slot):
        self.prep = prep
        self.slot = slot
        self.packed = None
        self.error: Optional[BaseException] = None


class SpGEMMTicket:
    """Ordered handle for one submitted step; redeem with
    :meth:`result` (or ``pipeline.collect(ticket)``)."""

    __slots__ = ("_pipe", "index", "batch")

    def __init__(self, pipe: "SpGEMMPipeline", index: int,
                 batch: Optional[int]):
        self._pipe = pipe
        self.index = index
        self.batch = batch  # None for single-shot, batch size otherwise

    def result(self):
        """Block until this step's C is on the host and return it (a CSR,
        or a list of CSRs for a batched submission)."""
        return self._pipe.collect(self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"SpGEMMTicket(index={self.index}"
                + (f", batch={self.batch}" if self.batch else "") + ")")


def _discard_outstanding(plan, steps: dict, free: list, lock: threading.Lock) -> None:
    """Drop every outstanding step, return its stream slot and balance the
    plan's in-flight count. Module-level (no pipeline reference) so
    ``weakref.finalize`` can run it after the pipeline itself is
    collected. A dropped step's device work is not waited for: every
    tensor it reads that another stream made was marked with
    ``record_stream`` at dispatch, so its memory is not reused before the
    step's stream has passed it."""
    with lock:
        dropped = list(steps.values())
        steps.clear()
        free.extend(step.slot for step in dropped)
    for _ in dropped:
        plan._pipe_end()


ValueItem = Union[Tuple, dict]


class SpGEMMPipeline:
    """Bounded-depth asynchronous serving pipeline over one
    :class:`~repro_torch.spgemm.plan.SpGEMMPlan`.

    ``depth`` bounds in-flight steps (2 = the paper's double buffer: one
    step copying while one computes). Construct directly or via
    ``plan.pipeline(depth=...)``; typical streaming use::

        with plan.pipeline(depth=2) as pipe:
            for c in pipe.stream(stream.value_iter(steps=100)):
                consume(c)

    or explicit submit/collect::

        t0 = pipe.submit(a0, b0)
        t1 = pipe.submit(a1, b1)   # overlaps t0's kernel
        c0 = pipe.collect(t0)      # or collect(t1) first: out of order OK
        c1 = t1.result()

    Thread-safe; a single pipeline's submissions are ordered by ticket
    index. Submission is stateless with respect to the plan's staged
    values (the no-arg ``submit()`` reuses them, like no-arg ``execute``).
    """

    def __init__(self, plan, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.plan = plan
        self.depth = int(depth)
        self._lock = threading.Lock()
        self._steps: dict = {}  # index -> _Step (outstanding only)
        self._next = 0
        self._closed = False
        # One stream per slot on a CUDA plan (None on the CPU), from the
        # plan's pool. A slot is free once no step holds it: not while the
        # step is outstanding, nor while a collect waits for it (collect
        # drops the step from ``_steps`` first and frees the slot after
        # its wait), so the free list, not ``_steps``, is the depth bound
        # a concurrent submit checks.
        self._streams = plan._pipe_streams(self.depth)
        self._free = list(range(self.depth))
        # Abandonment guard: a pipeline (or a lone execute_async ticket)
        # dropped with outstanding steps must not pin the plan's
        # in-flight count forever. The finalizer discards whatever is
        # still outstanding when the pipeline is garbage-collected;
        # close() runs the same discard eagerly (finalize is call-once,
        # so the two never double-release).
        self._finalizer = weakref.finalize(
            self, _discard_outstanding, plan, self._steps, self._free, self._lock)

    # -- introspection -----------------------------------------------------

    @property
    def in_flight(self) -> int:
        """Outstanding (submitted, not yet collected) steps."""
        with self._lock:
            return len(self._steps)

    @property
    def free_slots(self) -> int:
        """Submissions currently possible without
        :class:`PipelineFullError` (0 once closed): ``depth`` less the
        outstanding steps and the steps a ``collect`` is waiting for."""
        with self._lock:
            if self._closed:
                return 0
            return len(self._free)

    def __len__(self) -> int:
        return self.in_flight

    # -- submit / collect --------------------------------------------------

    def submit(self, a_vals=None, b_vals=None) -> SpGEMMTicket:
        """Dispatch one step; returns at once with a ticket.

        Operand shapes follow ``execute``/``execute_batch``: ``[nnz]``
        value vectors (element plans) or packed block arrays (block
        plans), with an optional leading batch axis (the ticket then
        redeems to a list of CSRs, exactly ``execute_batch``'s output).
        Passing neither reuses the plan's staged values. Raises
        :class:`PipelineFullError` when ``depth`` steps are already in
        flight: collect one first (``stream`` does this for you).
        Invalid operands raise here, without consuming a slot; failures
        *after* validation (dispatch errors) are stored on the ticket and
        re-raised by ``collect``.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("pipeline is closed")
            if not self._free:
                raise PipelineFullError(
                    f"pipeline depth {self.depth} exhausted "
                    f"({self.depth - len(self._steps)} step(s) being collected, "
                    f"{len(self._steps)} more in flight); collect a result "
                    f"before submitting more"
                )
            prep = self.plan._pipe_check(a_vals, b_vals)
            self.plan._pipe_begin(prep.n_execs)
            index = self._next
            self._next += 1
            step = _Step(prep, self._free.pop())
            try:
                step.packed = self.plan._pipe_dispatch(prep, self._streams[step.slot])
            except Exception as e:
                # Poisoned step: the slot is held (collect re-raises and
                # frees it); other in-flight steps are unaffected.
                step.error = e
            except BaseException:
                # KeyboardInterrupt/SystemExit must propagate, not hide in
                # a ticket; undo the slot and the in-flight accounting.
                self._free.append(step.slot)
                self.plan._pipe_end()
                raise
            self._steps[index] = step
            return SpGEMMTicket(self, index, prep.batch)

    def collect(self, ticket: Optional[SpGEMMTicket] = None):
        """Wait for one step and return its result.

        ``ticket=None`` collects the oldest outstanding step. Returns a
        CSR (single-shot) or a list of CSRs (batched submission) sharing
        the plan's precomputed ``indptr``/``indices``. Re-raises the
        step's stored error, if any; the ticket's slot is freed either
        way.
        """
        with self._lock:
            if ticket is None:
                if not self._steps:
                    raise ValueError("nothing in flight to collect")
                index = min(self._steps)
            else:
                if ticket._pipe is not self:
                    raise ValueError(
                        "ticket belongs to a different pipeline")
                index = ticket.index
                if index not in self._steps:
                    raise ValueError(
                        f"ticket {index} was already collected")
            step = self._steps.pop(index)
        try:
            if step.error is not None:
                raise step.error
            return self.plan._pipe_collect(step.prep, step.packed)
        finally:
            # The slot's stream is free once this step's copy is waited
            # for (or its dispatch failed): later work on it is ordered.
            with self._lock:
                self._free.append(step.slot)
            self.plan._pipe_end()

    # -- streaming ---------------------------------------------------------

    def __iter__(self) -> Iterator:
        """Drain: collect every outstanding step, oldest first."""
        while True:
            with self._lock:
                if not self._steps:
                    return
            yield self.collect()

    def stream(self, value_iter: Iterable[ValueItem]) -> Iterator:
        """Pump ``value_iter`` through the pipeline at full depth,
        yielding ordered results.

        Items are ``(a_vals, b_vals)`` tuples or ``{"a_vals": ...,
        "b_vals": ...}`` dicts (what ``SpGEMMValueStream.iter`` /
        ``value_iter`` produce). Keeps ``depth`` steps in flight, so
        copies overlap compute throughout; results come back in
        submission order. Abandoning the iterator mid-stream discards
        whatever is still in flight.
        """
        try:
            for item in value_iter:
                a_vals, b_vals = self._coerce(item)
                while self.in_flight >= self.depth:
                    yield self.collect()
                self.submit(a_vals, b_vals)
            yield from self
        finally:
            if self.in_flight:  # abandoned mid-stream
                self.close()

    @staticmethod
    def _coerce(item: ValueItem):
        if isinstance(item, dict):
            return item["a_vals"], item["b_vals"]
        a_vals, b_vals = item
        return a_vals, b_vals

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Discard all outstanding steps (their results never reach the
        host) and refuse further submits. Releases the plan's in-flight
        accounting, so buffer teardown (``release_values`` etc.) becomes
        legal again."""
        with self._lock:
            self._closed = True
        _discard_outstanding(self.plan, self._steps, self._free, self._lock)

    def __enter__(self) -> "SpGEMMPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
