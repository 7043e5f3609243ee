"""Multi-tenant SpGEMM serving gateway: micro-batching, fair scheduling,
backpressure, and per-pattern metrics over the plan/execute stack.

FSpGEMM amortizes per-matrix preprocessing so the steady state is a
stream of numeric executes against a fixed pattern; at fleet scale that
stream is *many* tenants hammering *many* recurring patterns
concurrently. :class:`SpGEMMGateway` is the front end above per-plan
pipelines that admits that traffic:

* **Submit/collect per request.** ``submit(pattern_token, a_vals,
  b_vals)`` returns a :class:`GatewayTicket` immediately; redeem with
  ``ticket.wait()`` (a typed :class:`GatewayResult`) or
  ``ticket.result()`` (the CSR, raising on shed/failure). Patterns are
  named by the ``pattern_token`` fast key: :meth:`register`
  resolves the plan once through :class:`~repro_torch.spgemm.cache.PlanCache`
  and every subsequent request is numeric-only.
* **Micro-batching.** Same-pattern requests arriving within
  ``batch_window`` seconds (or piling up to ``max_batch``) are stacked
  into ONE batched pipeline submission — ``execute_batch`` semantics, so
  each request's result is **bitwise-equal** to a direct
  ``plan.execute`` of its values.
* **Fair scheduling.** Dispatch is deficit round-robin by pending
  **value bytes** over a bounded pool of at most ``max_pipelines`` live
  :class:`~repro_torch.spgemm.pipeline.SpGEMMPipeline` objects: each ripe
  pattern earns an equal byte quantum per round, so one hot tenant can
  queue a million requests without starving the rest. Pool eviction only
  ever closes an *idle* pipeline (``in_flight == 0``) — the plan's pin
  guard means a pipeline with outstanding tickets is never torn down.
* **Admission control / backpressure.** Overload produces explicit typed
  outcomes (:class:`Outcome`), never executor exceptions: a full
  per-pattern queue sheds ``SHED_QUEUE_FULL``, exceeding the gateway's
  total in-flight byte budget sheds ``SHED_BYTES``, a
  :class:`~repro_torch.spgemm.cache.PlanCache` over its byte budget sheds
  ``SHED_CACHE_PRESSURE``, and a closing gateway sheds ``SHED_CLOSED``.
  Shed tickets resolve immediately; admitted work that fails on device
  resolves ``FAILED`` with the error attached.
* **Metrics.** Per-pattern queue depth, batch-fill ratio, p50/p99
  latency, throughput, and shed counts are recorded in a
  :class:`~repro_torch.runtime.heartbeat.MetricsRegistry` (pass your own to
  share it with a :class:`~repro_torch.runtime.heartbeat.Heartbeat` exporter);
  :meth:`stats` snapshots everything, including ``PlanCache.stats()``.

Threading model: ``submit`` is safe from any number of threads; one
dispatcher thread forms batches and dispatches them (on the card every
step only enqueues work on its pipeline slot's CUDA stream, under the
plan's device as the thread's current device — nothing blocks), one
collector thread waits for each step's device-to-host copy and resolves
tickets. A pattern's pipeline keeps up to ``depth`` batches in flight, so
staging for batch ``k+1`` overlaps batch ``k``'s kernel exactly as in
:mod:`repro_torch.spgemm.pipeline`. ``SpGEMMPipeline.collect`` does not
hold the pipeline's lock while it waits, so the dispatcher's next
``submit`` never queues behind the collector.

Request values may be numpy arrays or tensors (on the host or on the
plan's device); a micro-batch of numpy arrays is stacked with numpy, any
other with torch in the plan's value dtype, rounded exactly as ``execute``
rounds them. Every result owns its values: a step copies C into a fresh
pinned host tensor, never into a buffer a later step reuses.

PyTorch's ``torch.cuda.set_sync_debug_mode`` is process-wide: the
collector's waits are synchronizations, so do not set it to ``"error"``
while a gateway runs.
"""
from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

import contextlib

import numpy as np
import torch

from repro_torch.runtime.heartbeat import MetricsRegistry
from repro_torch.spgemm.cache import PlanCache, default_cache
from repro_torch.spgemm.pipeline import SpGEMMPipeline
from repro_torch.spgemm.plan import SpGEMMPlan, _as_tensor, spgemm_plan

__all__ = [
    "GatewayResult",
    "GatewayShed",
    "GatewayTicket",
    "Outcome",
    "SpGEMMGateway",
]


class Outcome(enum.Enum):
    """Terminal state of one gateway request."""

    OK = "ok"
    SHED_QUEUE_FULL = "shed_queue_full"  # per-pattern queue at max_queue
    SHED_BYTES = "shed_bytes"  # gateway in-flight byte budget exceeded
    SHED_CACHE_PRESSURE = "shed_cache_pressure"  # PlanCache over byte budget
    SHED_CLOSED = "shed_closed"  # gateway draining or closed
    FAILED = "failed"  # admitted, but dispatch/device execution errored

    @property
    def shed(self) -> bool:
        return self.value.startswith("shed_")


@dataclasses.dataclass
class GatewayResult:
    """Typed outcome of one request (what ``ticket.wait()`` returns).

    ``value`` is the CSR result for ``OK``, ``error`` the stored exception
    for ``FAILED``; sheds carry neither. ``latency_s`` is submit-to-resolve
    wall time; ``seq`` is the gateway-wide completion sequence number
    (sheds resolve with ``seq=0`` — they never enter the scheduler)."""

    outcome: Outcome
    pattern: str
    value: object = None
    error: Optional[BaseException] = None
    latency_s: float = 0.0
    seq: int = 0


class GatewayShed(RuntimeError):
    """Raised by ``ticket.result()`` for a shed request (callers that
    prefer typed outcomes use ``ticket.wait()`` instead)."""

    def __init__(self, outcome: Outcome, pattern: str):
        super().__init__(
            f"request for pattern {pattern!r} was shed: {outcome.value}"
        )
        self.outcome = outcome
        self.pattern = pattern


class GatewayTicket:
    """Future-like handle for one submitted request."""

    __slots__ = ("pattern", "_event", "_result")

    def __init__(self, pattern: str):
        self.pattern = pattern
        self._event = threading.Event()
        self._result: Optional[GatewayResult] = None

    def _resolve(self, result: GatewayResult) -> None:
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> GatewayResult:
        """Block until resolved; returns the typed :class:`GatewayResult`
        (never raises for sheds/failures). Raises ``TimeoutError`` if the
        request is still pending after ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request for pattern {self.pattern!r} still pending after "
                f"{timeout}s"
            )
        return self._result

    def result(self, timeout: Optional[float] = None):
        """Block and return the CSR; raises :class:`GatewayShed` for shed
        requests and re-raises the stored error for failed ones."""
        r = self.wait(timeout)
        if r.outcome is Outcome.OK:
            return r.value
        if r.outcome is Outcome.FAILED:
            raise r.error
        raise GatewayShed(r.outcome, self.pattern)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        state = self._result.outcome.value if self._event.is_set() else "pending"
        return f"GatewayTicket(pattern={self.pattern!r}, {state})"


class _Request:
    __slots__ = ("a", "b", "nbytes", "ticket", "t_submit")

    def __init__(self, a, b, nbytes, ticket, t_submit):
        self.a = a
        self.b = b
        self.nbytes = nbytes
        self.ticket = ticket
        self.t_submit = t_submit


class _PatternState:
    """One registered pattern: its plan, queue, scheduler state, and
    metric instruments."""

    def __init__(
        self, token: str, plan: SpGEMMPlan, reg: MetricsRegistry,
        depth: int = 2,
    ):
        self.token = token
        self.plan = plan
        self.depth = depth  # pipeline depth for this pattern (tuned or
        # the gateway default), resolved once at registration
        self.queue: deque = deque()  # admitted, not yet dispatched
        self.pending_bytes = 0  # queued + dispatched-not-resolved
        self.deficit = 0.0  # DRR byte credit
        self.pipeline: Optional[SpGEMMPipeline] = None
        self.last_active = 0.0  # pool-eviction LRU key
        self.first_admit: Optional[float] = None
        p = f"gateway.{token}"
        self.m_submitted = reg.counter(f"{p}.submitted")
        self.m_completed = reg.counter(f"{p}.completed")
        self.m_failed = reg.counter(f"{p}.failed")
        self.m_dispatches = reg.counter(f"{p}.dispatches")
        self.m_batched = reg.counter(f"{p}.batched_requests")
        self.m_queue_depth = reg.gauge(f"{p}.queue_depth")
        self.m_pending_bytes = reg.gauge(f"{p}.pending_bytes")
        self.m_latency = reg.summary(f"{p}.latency_s")
        self._reg = reg
        self._shed: Dict[str, object] = {}

    def shed_counter(self, outcome: Outcome):
        c = self._shed.get(outcome.value)
        if c is None:
            c = self._reg.counter(f"gateway.{self.token}.{outcome.value}")
            self._shed[outcome.value] = c
        return c


# Dispatcher poll when ripe work is blocked on pipeline slots (the
# collector's notify usually wakes it sooner).
_BLOCKED_POLL_S = 0.005


def _request_values(vals):
    """One request's operand as held until dispatch: a detached tensor,
    or a numpy array."""
    if isinstance(vals, torch.Tensor):
        return vals.detach()
    return np.asarray(vals)


def _nbytes(vals) -> int:
    if isinstance(vals, torch.Tensor):
        return vals.numel() * vals.element_size()
    return int(vals.nbytes)


def _stack(vals: list, dtype: torch.dtype):
    """A micro-batch's operands along a new leading axis: numpy arrays
    of one dtype stack with numpy (the plan rounds them as ``execute``
    does); any other mix becomes one tensor of the plan's value
    ``dtype``, on the device of the first tensor among them."""
    if all(isinstance(v, np.ndarray) for v in vals) and len({v.dtype for v in vals}) == 1:
        return np.stack(vals)
    device = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    return torch.stack([_as_tensor(v, dtype).to(device) for v in vals])


def _current_device(device: torch.device):
    """``device`` as the calling thread's current CUDA device (nothing
    for a CPU plan)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class SpGEMMGateway:
    """Serving front end over many concurrently-hammered sparsity
    patterns. See the module docstring for the design; typical use::

        gw = SpGEMMGateway(max_pipelines=4, depth=2, max_batch=8,
                           max_inflight_bytes=64 << 20)
        gw.register("tenant0/layer3", a_coo, b_coo, tile=16, group=2)
        t = gw.submit("tenant0/layer3", a_vals, b_vals)
        res = t.wait()            # typed GatewayResult
        if res.outcome is Outcome.OK:
            consume(res.value)    # CSR, bitwise == plan.execute(a, b)
        gw.close()                # drains by default

    Constructor parameters:

    * ``cache`` — the :class:`PlanCache` plans resolve through (default:
      the process cache). Its byte budget is an admission signal:
      ``cache.over_budget`` sheds ``SHED_CACHE_PRESSURE``.
    * ``max_pipelines`` — bound on live pipelines (device-buffer pool);
      ``depth`` — in-flight batches per pipeline (2 = the paper's double
      buffer).
    * ``max_batch`` / ``batch_window`` — micro-batch bounds: dispatch
      when ``max_batch`` same-pattern requests are queued or the oldest
      has waited ``batch_window`` seconds.
    * ``max_queue`` — per-pattern admitted-queue bound
      (``SHED_QUEUE_FULL`` past it); ``max_inflight_bytes`` — total
      value bytes admitted and not yet resolved (``SHED_BYTES`` past it;
      ``None`` = unbounded).
    * ``quantum_bytes`` — DRR byte quantum per pattern per round
      (default: sized so every pattern can dispatch one full batch per
      round).
    * ``metrics`` — a shared :class:`MetricsRegistry` (e.g. one also
      carried by a :class:`~repro_torch.runtime.heartbeat.Heartbeat`).
    * ``start=False`` defers the scheduler threads until :meth:`start`
      — submissions queue (and shed rules apply) but nothing dispatches.
    """

    def __init__(
        self,
        *,
        cache: Optional[PlanCache] = None,
        metrics: Optional[MetricsRegistry] = None,
        max_pipelines: int = 4,
        depth: int = 2,
        max_batch: int = 8,
        batch_window: float = 0.002,
        max_queue: int = 256,
        max_inflight_bytes: Optional[int] = None,
        quantum_bytes: Optional[int] = None,
        start: bool = True,
    ):
        if max_pipelines < 1:
            raise ValueError(f"max_pipelines must be >= 1, got {max_pipelines}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if batch_window < 0:
            raise ValueError(f"batch_window must be >= 0, got {batch_window}")
        self.cache = cache if cache is not None else default_cache()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.max_pipelines = int(max_pipelines)
        self.depth = int(depth)
        self.max_batch = int(max_batch)
        self.batch_window = float(batch_window)
        self.max_queue = int(max_queue)
        self.max_inflight_bytes = max_inflight_bytes
        self.quantum_bytes = quantum_bytes
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._states: "OrderedDict[str, _PatternState]" = OrderedDict()
        self._collectq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._inflight_bytes = 0  # admitted and not yet resolved
        self._pipelines_live = 0
        self._pipeline_evictions = 0
        self._seq = 0  # completion sequence (fairness observability)
        self._rr = 0  # round-robin rotation
        self._draining = False
        self._closed = False
        self._started = False
        self._t0 = time.perf_counter()
        self._dispatcher: Optional[threading.Thread] = None
        self._collector: Optional[threading.Thread] = None
        self.m_inflight_bytes = self.metrics.gauge("gateway.inflight_bytes")
        self.m_pipelines_live = self.metrics.gauge("gateway.pipelines_live")
        if start:
            self.start()

    # -- control plane -----------------------------------------------------

    def register(
        self,
        pattern_token: str,
        a,
        b,
        *,
        tile=64,
        group: int = 4,
        backend: str = "auto",
        device="cuda",
        mesh=None,
        mesh_axis=None,
        autotune=None,
    ) -> SpGEMMPlan:
        """Resolve (build or fetch) the plan for one pattern and open it
        for ``submit``. All symbolic work happens here, once; warm
        re-registrations hit the ``pattern_token`` fast key and pay
        neither ``to_coo`` nor the pattern digest. ``device="cuda"`` (the
        default) serves the pattern through the card's kernels and raises
        without one; ``device="cpu"`` serves it through the plain version.

        ``autotune=True`` (or a dict of
        :func:`repro_torch.spgemm.autotune.autotune_plan` overrides) applies
        the per-pattern tuned config — searched once, persisted with the
        plan artifacts, loaded probe-free on a warm restart. A tuned
        pipeline depth overrides the gateway's default ``depth`` for
        this pattern only; ``stats()`` reports the provenance."""
        plan = spgemm_plan(
            a, b, tile=tile, group=group, backend=backend, device=device,
            cache=self.cache, mesh=mesh, mesh_axis=mesh_axis,
            pattern_token=pattern_token, autotune=autotune,
        )
        return self.register_plan(pattern_token, plan)

    def register_plan(self, pattern_token: str, plan: SpGEMMPlan) -> SpGEMMPlan:
        """Open an already-built plan for ``submit`` under ``pattern_token``
        (the seam for sharded/externally-cached plans)."""
        token = str(pattern_token)
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is closed")
            state = self._states.get(token)
            if state is not None:
                if state.plan is not plan:
                    raise ValueError(
                        f"pattern_token {token!r} is already registered "
                        f"with a different plan"
                    )
                return plan
            # Pipeline depth: the plan's tuned depth when an autotuner
            # config is applied, else the gateway default.
            depth = (
                plan._default_depth()
                if getattr(plan, "tuned_config", None) is not None
                else self.depth
            )
            self._states[token] = _PatternState(
                token, plan, self.metrics, depth=depth
            )
        return plan

    def patterns(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._states)

    def start(self) -> None:
        """Start the dispatcher/collector threads (idempotent)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is closed")
            if self._started:
                return
            self._started = True
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="spgemm-gateway-dispatch",
            daemon=True,
        )
        self._collector = threading.Thread(
            target=self._collect_loop, name="spgemm-gateway-collect",
            daemon=True,
        )
        self._dispatcher.start()
        self._collector.start()

    # -- data plane --------------------------------------------------------

    def submit(self, pattern_token: str, a_vals, b_vals) -> GatewayTicket:
        """Admit one request for a registered pattern.

        Always returns a ticket: admission failures resolve it
        *immediately* with a typed shed outcome (``ticket.done()`` is
        already True) — overload is data, not an exception. Programming
        errors still raise here: an unregistered token is ``KeyError``,
        operand shapes not matching ``plan.value_shapes()`` are
        ``ValueError``. Values are numpy arrays (or anything
        ``np.asarray`` takes) or tensors; they are held, not copied, until
        their batch is dispatched.
        """
        token = str(pattern_token)
        with self._lock:
            state = self._states.get(token)
        if state is None:
            raise KeyError(
                f"pattern_token {token!r} is not registered; call "
                f"register(token, a, b) first"
            )
        want_a, want_b = state.plan.value_shapes()
        a = _request_values(a_vals)
        b = _request_values(b_vals)
        if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
            raise ValueError(
                f"pattern {token!r}: expected a_vals {want_a} / b_vals "
                f"{want_b} (one request per submit), got {tuple(a.shape)} / "
                f"{tuple(b.shape)}"
            )
        nbytes = _nbytes(a) + _nbytes(b)
        ticket = GatewayTicket(token)
        now = time.perf_counter()
        with self._cond:
            outcome = None
            if self._closed or self._draining:
                outcome = Outcome.SHED_CLOSED
            elif len(state.queue) >= self.max_queue:
                outcome = Outcome.SHED_QUEUE_FULL
            elif (
                self.max_inflight_bytes is not None
                and self._inflight_bytes + nbytes > self.max_inflight_bytes
            ):
                outcome = Outcome.SHED_BYTES
            elif self.cache.over_budget:
                outcome = Outcome.SHED_CACHE_PRESSURE
            if outcome is not None:
                state.shed_counter(outcome).inc()
                ticket._resolve(GatewayResult(outcome, token))
                return ticket
            state.queue.append(_Request(a, b, nbytes, ticket, now))
            state.pending_bytes += nbytes
            self._inflight_bytes += nbytes
            if state.first_admit is None:
                state.first_admit = now
            state.m_submitted.inc()
            state.m_queue_depth.set(len(state.queue))
            state.m_pending_bytes.set(state.pending_bytes)
            self.m_inflight_bytes.set(self._inflight_bytes)
            self._cond.notify_all()
        return ticket

    # -- scheduler (dispatcher thread) -------------------------------------

    def _ripe_locked(self, state: _PatternState, now: float) -> bool:
        if not state.queue:
            return False
        if self._draining or len(state.queue) >= self.max_batch:
            return True
        return (now - state.queue[0].t_submit) >= self.batch_window

    def _wait_time_locked(self, now: float) -> Optional[float]:
        """Seconds until the next pattern ripens: 0.0 when one is ripe
        now, ``None`` when every queue is empty (sleep until notified)."""
        soonest = None
        for state in self._states.values():
            if not state.queue:
                continue
            if self._ripe_locked(state, now):
                return 0.0
            w = self.batch_window - (now - state.queue[0].t_submit)
            soonest = w if soonest is None else min(soonest, w)
        return soonest

    def _quantum_locked(self) -> float:
        """DRR byte credit added per ripe pattern per round. Default:
        large enough that every pattern can dispatch one full micro-batch
        per round — so under contention each round moves ~equal bytes per
        pattern, whatever each tenant's backlog is."""
        if self.quantum_bytes is not None:
            return float(self.quantum_bytes)
        head = max(
            (s.queue[0].nbytes for s in self._states.values() if s.queue),
            default=1,
        )
        return float(head * self.max_batch)

    def _acquire_pipeline_locked(self, state: _PatternState, planned, actions):
        """Ensure ``state`` can take one more in-flight batch; returns
        True and records create/evict actions (performed outside the
        lock) if so.

        Eviction honors the pin guard: only pipelines with zero in-flight
        tickets are candidates — a busy pipeline is never torn down, the
        requesting pattern just waits for the collector to free one."""
        if state.pipeline is not None:
            return state.pipeline.free_slots - planned.get(state.token, 0) > 0
        if ("create", state) in actions:  # planned earlier this round
            return planned.get(state.token, 0) < state.depth
        if self._pipelines_live < self.max_pipelines:
            self._pipelines_live += 1
            actions.append(("create", state))
            return True
        # Pool full: evict the least-recently-active idle pipeline,
        # preferring one with no queued work.
        victims = [
            s for s in self._states.values()
            if s.pipeline is not None and s.pipeline.in_flight == 0
            and planned.get(s.token, 0) == 0
        ]
        if not victims:
            return False
        idle = [s for s in victims if not s.queue]
        pool = idle if idle else victims
        victim = min(pool, key=lambda s: s.last_active)
        actions.append(("close", victim.pipeline))
        victim.pipeline = None
        self._pipeline_evictions += 1
        actions.append(("create", state))
        return True

    def _plan_round_locked(self, now: float):
        """One DRR round: pick per-pattern micro-batches (popped from the
        queues) plus the pipeline create/close actions they need."""
        states = list(self._states.values())
        if not states:
            return [], []
        batches = []  # (state, [requests])
        actions = []  # ("create", state) | ("close", pipeline)
        planned: Dict[str, int] = {}  # batches planned per token this round
        quantum = self._quantum_locked()
        n = len(states)
        for i in range(n):
            state = states[(self._rr + i) % n]
            if not state.queue:
                state.deficit = 0.0  # classic DRR: credit dies with backlog
                continue
            if not self._ripe_locked(state, now):
                continue
            if not self._acquire_pipeline_locked(state, planned, actions):
                continue
            state.deficit += quantum
            while state.queue and self._ripe_locked(state, now):
                k = min(len(state.queue), self.max_batch)
                nbytes = sum(state.queue[j].nbytes for j in range(k))
                if nbytes > state.deficit:
                    break  # spend next round's credit, not this one's
                if not self._acquire_pipeline_locked(state, planned, actions):
                    break
                reqs = [state.queue.popleft() for _ in range(k)]
                state.deficit -= nbytes
                planned[state.token] = planned.get(state.token, 0) + 1
                batches.append((state, reqs))
            state.m_queue_depth.set(len(state.queue))
        self._rr = (self._rr + 1) % n
        return batches, actions

    def _run_round(self, batches, actions) -> None:
        """Perform a planned round outside the gateway lock: pool
        mutations, then one pipeline submission per micro-batch (each
        only enqueues device work — nothing here blocks on the card). A
        CUDA plan's submission runs with the plan's device current on
        this thread, so every launch and allocation lands there."""
        for kind, obj in actions:
            if kind == "close":
                obj.close()  # idle by construction: nothing discarded
            else:  # "create"
                obj.pipeline = SpGEMMPipeline(obj.plan, depth=obj.depth)
        now = time.perf_counter()
        for state, reqs in batches:
            state.last_active = now
            plan = state.plan
            try:
                a = _stack([r.a for r in reqs], plan._a_dtype)
                b = _stack([r.b for r in reqs], plan._b_dtype)
                with _current_device(plan.device):
                    ticket = state.pipeline.submit(a, b)
            except Exception as e:
                self._resolve_batch(state, reqs, None, e)
                continue
            state.m_dispatches.inc()
            state.m_batched.inc(len(reqs))
            self._collectq.put((state, state.pipeline, ticket, reqs))
        with self._lock:
            self.m_pipelines_live.set(self._pipelines_live)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                now = time.perf_counter()
                batches, actions = self._plan_round_locked(now)
                if not batches and not actions:
                    w = self._wait_time_locked(time.perf_counter())
                    # w == 0.0: ripe but blocked on pipeline slots — the
                    # collector's notify (or the poll) retries the round.
                    self._cond.wait(
                        timeout=_BLOCKED_POLL_S if w == 0.0 else w
                    )
                    continue
            self._run_round(batches, actions)

    # -- collector thread --------------------------------------------------

    def _resolve_batch(self, state, reqs, outs, error) -> None:
        now = time.perf_counter()
        with self._cond:
            for i, r in enumerate(reqs):
                self._seq += 1
                if error is None:
                    res = GatewayResult(
                        Outcome.OK, state.token, value=outs[i],
                        latency_s=now - r.t_submit, seq=self._seq,
                    )
                    state.m_completed.inc()
                    state.m_latency.record(res.latency_s)
                else:
                    res = GatewayResult(
                        Outcome.FAILED, state.token, error=error,
                        latency_s=now - r.t_submit, seq=self._seq,
                    )
                    state.m_failed.inc()
                state.pending_bytes -= r.nbytes
                self._inflight_bytes -= r.nbytes
                r.ticket._resolve(res)
            state.m_pending_bytes.set(state.pending_bytes)
            self.m_inflight_bytes.set(self._inflight_bytes)
            self._cond.notify_all()  # wakes drain() and a blocked dispatcher

    def _collect_loop(self) -> None:
        while True:
            item = self._collectq.get()
            if item is None:
                return
            state, pipe, ticket, reqs = item
            try:
                outs = pipe.collect(ticket)  # the only blocking D2H
                error = None
            except Exception as e:
                outs, error = None, e
            self._resolve_batch(state, reqs, outs, error)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Point-in-time snapshot: per-pattern serving metrics plus
        gateway- and cache-level counters (all plain values, JSON-safe
        modulo the cache's path strings)."""
        now = time.perf_counter()
        with self._lock:
            states = list(self._states.values())
            inflight = self._inflight_bytes
            live = self._pipelines_live
            evictions = self._pipeline_evictions
        patterns = {}
        for s in states:
            dispatches = s.m_dispatches.value
            batched = s.m_batched.value
            completed = s.m_completed.value
            elapsed = (now - s.first_admit) if s.first_admit else 0.0
            shed = {k: c.value for k, c in s._shed.items()}
            patterns[s.token] = {
                "queued": len(s.queue),
                "pending_bytes": s.pending_bytes,
                "submitted": s.m_submitted.value,
                "completed": completed,
                "failed": s.m_failed.value,
                "shed": shed,
                "shed_total": sum(shed.values()),
                "dispatches": dispatches,
                "batched_requests": batched,
                "batch_fill": (batched / dispatches) if dispatches else 0.0,
                "throughput_rps": (completed / elapsed) if elapsed > 0 else 0.0,
                "latency_s": s.m_latency.snapshot(),
                # Exec-config provenance: which tier is active ("default",
                # "tuned", "persisted", "env-override") plus the applied
                # TunedConfig record (probe count, measured values/s,
                # model agreement) when the pattern was autotuned.
                "config_source": s.plan.report.config_source,
                "tuned": s.plan.report.tuned,
                "pipeline_depth": s.depth,
            }
        return {
            "patterns": patterns,
            "inflight_bytes": inflight,
            "pipelines_live": live,
            "pipeline_evictions": evictions,
            "cache": self.cache.stats(),
        }

    # -- teardown ----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every admitted request has resolved. Requires the
        scheduler to be running. Raises ``TimeoutError`` if work is still
        in flight after ``timeout`` seconds."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while self._inflight_bytes > 0 or any(
                s.queue for s in self._states.values()
            ):
                if not self._started:
                    raise RuntimeError(
                        "cannot drain: the gateway scheduler is not running"
                    )
                remaining = (
                    None if deadline is None
                    else deadline - time.perf_counter()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"gateway still has {self._inflight_bytes} bytes in "
                        f"flight after {timeout}s"
                    )
                self._cond.wait(timeout=remaining)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the gateway. ``drain=True`` (default) finishes all
        admitted work first; ``drain=False`` sheds everything still
        queued (``SHED_CLOSED``) but still resolves already-dispatched
        batches. New submissions shed ``SHED_CLOSED`` from the moment
        close begins. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._draining = True
            self._cond.notify_all()
        if drain and self._started:
            self.drain(timeout)
        with self._cond:
            self._closed = True
            for state in self._states.values():
                while state.queue:  # drain=False (or never-started) path
                    r = state.queue.popleft()
                    state.pending_bytes -= r.nbytes
                    self._inflight_bytes -= r.nbytes
                    state.shed_counter(Outcome.SHED_CLOSED).inc()
                    r.ticket._resolve(
                        GatewayResult(Outcome.SHED_CLOSED, state.token)
                    )
                state.m_queue_depth.set(0)
            self._cond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join()
        # Dispatcher is done pushing; the sentinel lands after its last
        # batch, so the collector resolves everything already dispatched
        # before exiting.
        self._collectq.put(None)
        if self._collector is not None:
            self._collector.join()
        with self._lock:
            states = list(self._states.values())
        for state in states:
            if state.pipeline is not None:
                state.pipeline.close()
                state.pipeline = None
        with self._lock:
            self._pipelines_live = 0
            self.m_pipelines_live.set(0)

    def __enter__(self) -> "SpGEMMGateway":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
