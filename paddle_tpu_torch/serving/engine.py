"""Continuous micro-batching engine (counterpart of
paddle_tpu/serving/engine.py): the scheduling layer between concurrent
single requests and batched dispatches of one predict callable.

- A bounded request queue with a future for each request: a full queue
  fast-fails with `RejectedError` (reason "queue_full", with the
  `retry_after_s` backpressure hint) instead of building unbounded
  latency; a draining engine rejects at once.
- A scheduler that coalesces requests into batches and flushes on
  `max_batch_size` rows or `max_wait_ms` since the oldest pending request,
  whichever comes first.
- Per-request deadlines enforced before dispatch: expired requests are
  dropped at batch formation, so their rows never reach the device.
- Shape discipline: a static callable is dispatched at the next power of
  two of the coalesced rows (bucketed batching), a dynamic one
  (`dynamic_batch=True`) at the exact count.
- Supervision: each dispatch runs under the `EngineSupervisor`
  (watchdog, typed `DispatchFailedError`, circuit breaker with
  `on_break`) and the fault plan's `dispatch_*` clauses, keyed on the
  engine's dispatch index.
- Economics (`EngineConfig(economics=True)`): each pump pass runs inside
  the `ServingLedger`'s ``measure("host")`` frame, and each successful
  dispatch's span is booked as `prefill_compute` (real rows useful, the
  pow2 padding the waste `token_efficiency` shows). `predict_fn` returns
  numpy, so the span already ends at the result on the host.

`predict_fn` takes a list of numpy arrays (a shared leading batch dim) and
returns a sequence of output arrays; a torch model on the card is wrapped
by the caller (numpy in, numpy out). `from_predictor` waits for the
port's `inference/` (ROADMAP item 9); the compile observatory
(`EngineConfig.observatory`) raises.

Every flush decision is a pure function of `clock.now()`. Under a
`SimClock` the engine runs threadless and `serving/sim.py` drives
`pump()` at scripted instants; under the default `MonotonicClock`,
`start()` runs the same `pump()` on a scheduler thread woken by a
condition variable.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..obs.flight_recorder import flight_recorder
from ..obs.trace import (SERVING_PHASES, RequestTrace, TimelineStore,
                         new_request_id)
from .clock import Clock, MonotonicClock, SimClock
from .metrics import ServingMetrics
from .supervisor import DispatchFailedError, EngineSupervisor

_log = logging.getLogger("paddle_tpu_torch.serving")


class RejectedError(RuntimeError):
    """Admission control fast-fail. `reason` is machine-readable and
    matches the reject-reason metric label ("queue_full", "draining",
    "shed", "token_budget", "circuit_open", "drain_timeout", ...);
    `retry_after_s`, when set, is the backpressure hint the HTTP layer
    surfaces as a Retry-After header on 429 responses."""

    def __init__(self, msg: str, reason: str = "rejected",
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired while queued; it was dropped before
    dispatch (its rows never reached the device)."""


@dataclass
class EngineConfig:
    max_batch_size: int = 8        # flush when coalesced rows reach this
    max_wait_ms: float = 5.0       # ...or the oldest request waited this long
    max_queue_depth: int = 256     # pending-request cap (admission control)
    max_request_rows: Optional[int] = None  # per-request row cap (None: an
    #                                         oversized request dispatches
    #                                         alone, pow2-padded)
    default_deadline_ms: Optional[float] = None  # per-request override wins
    bucket_pow2: Optional[bool] = None  # None: True for static exports /
    #                                     plain callables, False for
    #                                     symbolic-batch (dynamic) exports
    drain_timeout_s: float = 30.0
    dispatch_timeout_s: Optional[float] = None  # hung-dispatch watchdog
    #                                  (None: a wedged predict_fn blocks the
    #                                  scheduler until drain_timeout_s bails
    #                                  the queue out)
    breaker_threshold: int = 3     # consecutive failed dispatches that open
    #                                the engine circuit breaker
    retry_after_s: float = 1.0     # backpressure hint on overload rejects
    economics: bool = False        # arm the serving economics ledger
    observatory: bool = False      # the compile observatory: not ported
    #                                yet (ROADMAP item 9)

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {self.max_batch_size}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.max_request_rows is not None and self.max_request_rows < 1:
            raise ValueError(
                f"max_request_rows must be >= 1, got "
                f"{self.max_request_rows}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}")
        if self.observatory:
            raise NotImplementedError(
                "EngineConfig(observatory=True): the compile observatory "
                "(obs/compile_observatory.py) is not ported yet, ROADMAP "
                "item 9")


class _Request:
    __slots__ = ("inputs", "rows", "arrival", "deadline", "future", "rid",
                 "trace")

    def __init__(self, inputs, rows, arrival, deadline):
        self.inputs = inputs          # list of np arrays, leading batch dim
        self.rows = rows
        self.arrival = arrival        # clock seconds
        self.deadline = deadline      # absolute clock seconds or None
        self.future: Future = Future()
        self.rid: Optional[str] = None
        self.trace: Optional[RequestTrace] = None  # None: untraced (the
        #                                            hot-path cost is one
        #                                            `is not None` test)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _coalescable(head: "_Request", r: "_Request") -> bool:
    """Two requests may share a dispatch only when their inputs concatenate
    cleanly AND mean the same thing to the executable: same input count,
    same trailing shapes, same dtypes. Independent HTTP clients owe each
    other nothing — without this check one client's odd shapes would poison
    a stranger's batch."""
    if len(head.inputs) != len(r.inputs):
        return False
    return all(a.shape[1:] == b.shape[1:] and a.dtype == b.dtype
               for a, b in zip(head.inputs, r.inputs))


class BatchingEngine:
    """`submit()` request rows, get a Future of per-request outputs.

    predict_fn: list-of-arrays (each with a shared leading batch dim) ->
        sequence of output arrays, numpy in and numpy out.
        `dynamic_batch=True` dispatches at the exact coalesced row count;
        otherwise (the default) at the next power of two.

    Each request's inputs must carry a leading batch dim (>= 1 rows); the
    engine concatenates along axis 0, dispatches, and splits batched
    outputs back by the request row counts. An output whose leading dim
    does not ride the batch is delivered whole to every request in the
    dispatch (constant / state-table outputs).
    """

    def __init__(self, predict_fn: Callable, config: Optional[EngineConfig]
                 = None, clock: Optional[Clock] = None,
                 metrics: Optional[ServingMetrics] = None,
                 dynamic_batch: bool = False, fault_plan=None,
                 on_break: Optional[Callable[[], None]] = None):
        self.predict_fn = predict_fn
        self.config = config or EngineConfig()
        self.clock = clock or MonotonicClock()
        self.metrics = metrics or ServingMetrics()
        self.dynamic_batch = bool(dynamic_batch)
        self._bucket = (not self.dynamic_batch
                        if self.config.bucket_pow2 is None
                        else bool(self.config.bucket_pow2))
        self._pending: deque = deque()
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # supervision: watchdog-bounded dispatches, a circuit breaker over
        # consecutive dispatch failures, and the shared fault-injection
        # plan (None -> the env-driven global plan)
        if fault_plan is None:
            from ..utils.fault_injection import global_plan
            fault_plan = global_plan()
        self._fault_plan = fault_plan
        self.on_break = on_break
        self.supervisor = EngineSupervisor(
            dispatch_timeout_s=self.config.dispatch_timeout_s,
            breaker_threshold=self.config.breaker_threshold,
            on_trip=self._on_breaker_trip, name="serving")
        self._dispatch_idx = 0   # running count of supervised dispatches
        # finished-request timelines, bounded LRU (served by the HTTP
        # layer's /debug/requests endpoint)
        self.timelines = TimelineStore(256)
        # serving economics: None unless armed, so every hook costs one
        # predicate when disabled
        self.ledger = None
        if self.config.economics:
            from ..obs.serving_ledger import ServingLedger
            self.ledger = ServingLedger(clock=self.clock.now)
        self.metrics.ledger = self.ledger
    # ---- lifecycle ----
    def start(self) -> "BatchingEngine":
        """Run the scheduler on a background thread (production mode). Not
        needed under a SimClock — the sim harness calls pump() itself."""
        if isinstance(self.clock, SimClock):
            raise RuntimeError(
                "BatchingEngine.start() with a SimClock would busy-spin: "
                "drive pump() from the simulation harness instead")
        with self._cond:
            if self._stopped:
                raise RuntimeError("engine already stopped")
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._scheduler_main, daemon=True,
                name="pdtpu-serving-scheduler")
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Graceful drain: stop admissions (submit -> RejectedError), flush
        every already-accepted request, then stop the scheduler. With
        drain=False pending futures fail with RejectedError instead."""
        with self._cond:
            if self._stopped:
                return
            self._draining = True
            flight_recorder().record("drain_begin", engine="serving",
                                     drain=drain, queued=len(self._pending))
            if not drain:
                while self._pending:
                    req = self._pending.popleft()
                    self._conclude(req, "rejected:shutdown")
                    req.future.set_exception(
                        RejectedError("engine shut down before dispatch",
                                      reason="shutdown"))
                    self.metrics.on_reject("shutdown")
                self.metrics.set_queue_depth(0)
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            join_s = (timeout if timeout is not None
                      else self.config.drain_timeout_s)
            thread.join(join_s)
            if thread.is_alive():
                _log.warning(
                    "serving drain did not complete within %.1fs; failing "
                    "requests still queued", join_s)
        else:
            # threadless (sim) mode: flush inline — draining makes every
            # pending batch due
            self.pump()
        with self._cond:
            # a timed-out (or dead) scheduler leaves accepted requests
            # queued forever — fail them now so waiting callers get a
            # definite answer instead of blocking until their own future
            # timeouts (after a clean drain this deque is already empty)
            stranded = 0
            while self._pending:
                req = self._pending.popleft()
                self._conclude(req, "rejected:drain_timeout")
                req.future.set_exception(RejectedError(
                    "engine drain timed out before dispatch",
                    reason="drain_timeout"))
                self.metrics.on_reject("drain_timeout")
                stranded += 1
            if stranded:
                self.metrics.set_queue_depth(0)
            self._stopped = True
            self._cond.notify_all()
        flight_recorder().record("drain_end", engine="serving",
                                 stranded=stranded)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def broken(self) -> bool:
        """Circuit breaker open: the engine saw `breaker_threshold`
        consecutive dispatch failures and has stopped admitting."""
        return self.supervisor.open

    def _on_breaker_trip(self):
        """Repeated engine-level failures: stop admitting (submit ->
        RejectedError reason "circuit_open"), fail everything still queued
        — each pending dispatch would only fail again — and notify the
        front end (which flips /healthz to 503 and starts a drain on its
        own thread)."""
        flushed = 0
        with self._cond:
            while self._pending:
                req = self._pending.popleft()
                self._conclude(req, "rejected:circuit_open")
                req.future.set_exception(RejectedError(
                    "engine circuit breaker open after repeated dispatch "
                    "failures", reason="circuit_open"))
                self.metrics.on_reject("circuit_open")
                flushed += 1
            self.metrics.set_queue_depth(0)
            self._cond.notify_all()
        flight_recorder().record("queue_flushed", engine="serving",
                                 reason="circuit_open", n=flushed)
        self.metrics.set_circuit_open(True)
        if self.on_break is not None:
            try:
                self.on_break()
            except Exception:
                _log.exception("on_break callback failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=True)
        return False

    # ---- tracing / black-box hooks ----
    def _conclude(self, req: _Request, outcome: str,
                  now: Optional[float] = None):
        """Finalize a request's trace (if any) and publish its timeline."""
        if req.trace is None:
            return
        tr = req.trace
        tr.finish(self.clock.now() if now is None else now, outcome)
        self.timelines.put(tr.rid, tr.to_dict())
        tr.emit_chrome()

    def _record_reject(self, reason: str, rid: Optional[str] = None):
        flight_recorder().record("reject", engine="serving", reason=reason,
                                 rid=rid)

    # ---- admission ----
    def submit(self, inputs, deadline_ms: Optional[float] = None,
               rid: Optional[str] = None, trace: bool = False) -> Future:
        """Admit one request. inputs: array or list of arrays, each with a
        leading batch dim (>= 1 rows, all inputs agreeing). Raises
        RejectedError when the queue is full or the engine is draining.

        `rid` is the request id (ingested from a `traceparent` header by
        the HTTP layer, or generated here); `trace=True` additionally
        records a structured timeline, retrievable from
        `engine.timelines` after the request finishes."""
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        arrays = [np.asarray(a) for a in inputs]
        if not arrays or arrays[0].ndim < 1:
            raise ValueError(
                "request inputs must be non-empty arrays with a leading "
                "batch dim (wrap a single sample as shape (1, ...))")
        rows = arrays[0].shape[0]
        for a in arrays:
            if a.ndim < 1 or a.shape[0] != rows:
                raise ValueError(
                    f"all request inputs must share the leading batch dim "
                    f"({rows}); got shapes "
                    f"{[tuple(x.shape) for x in arrays]}")
        rid = rid or new_request_id()
        if (self.config.max_request_rows is not None
                and rows > self.config.max_request_rows):
            self.metrics.on_reject("too_many_rows")
            self._record_reject("too_many_rows", rid=rid)
            raise RejectedError(
                f"request rows ({rows}) exceed max_request_rows "
                f"({self.config.max_request_rows})", reason="too_many_rows")
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        now = self.clock.now()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        with self._cond:
            if self.supervisor.open:
                self.metrics.on_reject("circuit_open")
                self._record_reject("circuit_open", rid=rid)
                raise RejectedError(
                    "engine circuit breaker open after repeated dispatch "
                    "failures; request rejected", reason="circuit_open")
            if self._draining or self._stopped:
                self.metrics.on_reject("draining")
                self._record_reject("draining", rid=rid)
                raise RejectedError("engine is draining; request rejected",
                                    reason="draining")
            if len(self._pending) >= self.config.max_queue_depth:
                self.metrics.on_reject("queue_full")
                self._record_reject("queue_full", rid=rid)
                raise RejectedError(
                    f"queue at capacity ({self.config.max_queue_depth} "
                    "pending requests)", reason="queue_full",
                    retry_after_s=self.config.retry_after_s)
            req = _Request(arrays, rows, now, deadline)
            req.rid = rid
            if trace:
                req.trace = RequestTrace(rid, now,
                                         phase_defs=SERVING_PHASES)
                req.trace.event("submitted", now, rows=rows)
            self._pending.append(req)
            self.metrics.on_submit(len(self._pending))
            self._cond.notify_all()
        return req.future

    def predict(self, inputs, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous convenience: submit + wait."""
        return self.submit(inputs, deadline_ms=deadline_ms).result(timeout)

    # ---- scheduling ----
    def next_event_time(self) -> Optional[float]:
        """Clock instant of the next time-driven action (oldest request's
        max_wait flush, or the earliest deadline expiry) — None when the
        queue is empty. The sim harness advances the clock here between
        scripted arrivals."""
        with self._cond:
            if not self._pending:
                return None
            t = self._pending[0].arrival + self.config.max_wait_ms / 1e3
            for r in self._pending:
                if r.deadline is not None:
                    t = min(t, r.deadline)
            return t

    def pump(self) -> int:
        """One scheduler pass: drop expired requests, dispatch every batch
        that is due at clock.now(). Returns the number of dispatches. This
        is THE scheduler: the background thread and the sim harness both
        call it. With economics armed the pass runs inside the ledger's
        ``measure("host")`` frame, out of which `_dispatch` books each
        predict's span."""
        led = self.ledger
        if led is None:
            return self._pump_inner()
        with led.measure("host"):
            return self._pump_inner()

    def _pump_inner(self) -> int:
        dispatched = 0
        while True:
            batch = self._take_batch()
            if not batch:
                return dispatched
            self._dispatch(batch)
            dispatched += 1

    def _take_batch(self) -> Optional[List[_Request]]:
        now = self.clock.now()
        with self._cond:
            self._drop_expired_locked(now)
            if not self._pending:
                return None
            total_rows = sum(r.rows for r in self._pending)
            # compare against the ABSOLUTE flush instant (the same
            # expression next_event_time/the scheduler thread compute) —
            # re-deriving a waited-duration here loses a float ulp and a
            # pump at exactly the flush instant would never come due
            flush_t = self._pending[0].arrival + self.config.max_wait_ms / 1e3
            due = (total_rows >= self.config.max_batch_size
                   or now >= flush_t
                   or self._draining)
            if not due:
                return None
            batch, rows = [], 0
            while self._pending:
                r = self._pending[0]
                if batch and (rows + r.rows > self.config.max_batch_size
                              or not _coalescable(batch[0], r)):
                    break       # incompatible request starts its own batch
                batch.append(self._pending.popleft())
                rows += r.rows
            self.metrics.set_queue_depth(len(self._pending))
            return batch

    def _drop_expired_locked(self, now: float):
        if not self._pending:
            return
        alive = deque()
        expired = 0
        for r in self._pending:
            if r.deadline is not None and now >= r.deadline:
                self._conclude(r, "expired:queued", now)
                r.future.set_exception(DeadlineExceededError(
                    f"deadline expired after "
                    f"{(now - r.arrival) * 1e3:.1f}ms in queue "
                    "(dropped before dispatch)"))
                expired += 1
            else:
                alive.append(r)
        if expired:
            self._pending = alive
            self.metrics.on_expire(expired)
            self.metrics.set_queue_depth(len(alive))

    # ---- dispatch ----
    def _supervised_predict(self, args):
        """One watchdog-bounded, fault-injectable predict dispatch. Raises
        DispatchFailedError / DispatchHungError, counted by the circuit
        breaker: the stateless engine has no per-request retry (a batch's
        rows left the queue; re-running them after a partial failure could
        double-apply side-effectful predictors), so every failed dispatch
        is an engine-level failure."""
        idx = self._dispatch_idx
        self._dispatch_idx += 1
        plan = self._fault_plan

        def guarded():
            if plan is not None:
                plan.maybe_dispatch_fault(idx, kind="predict")
            return self.predict_fn(args)

        try:
            outs = self.supervisor.run(guarded, label="predict")
        except DispatchFailedError as e:
            self.metrics.on_dispatch_failure(e.reason)
            self.supervisor.record_failure()
            raise
        self.supervisor.record_success()
        return outs

    def _dispatch(self, batch: List[_Request]):
        t0 = self.clock.now()
        total = sum(r.rows for r in batch)
        padded = total
        for r in batch:
            if r.trace is not None:
                r.trace.mark("dispatched", t0)
                r.trace.event("dispatched", t0, batch_rows=total,
                              batch_requests=len(batch))
        # batch assembly sits INSIDE the try: an exception anywhere between
        # here and predict_fn must fail this batch's futures, never escape
        # into (and kill) the scheduler thread
        try:
            n_inputs = len(batch[0].inputs)
            args = [np.concatenate([r.inputs[i] for r in batch], axis=0)
                    for i in range(n_inputs)]
            if self._bucket:
                if total <= self.config.max_batch_size:
                    padded = min(_next_pow2(total),
                                 self.config.max_batch_size)
                else:
                    # a single request larger than max_batch_size still
                    # dispatches on a pow2 shape, keeping the number of
                    # distinct compiled shapes logarithmic
                    padded = _next_pow2(total)
                if padded > total:
                    args = [np.concatenate(
                        [a,
                         np.zeros((padded - total,) + a.shape[1:], a.dtype)],
                        axis=0) for a in args]
            tc0 = self.clock.now() if self.ledger is not None else None
            outs = list(self._supervised_predict(args))
        except Exception as e:
            for r in batch:
                self._conclude(r, "failed:dispatch")
                r.future.set_exception(e)
            self.metrics.on_fail(len(batch))
            return
        if self.ledger is not None:
            # predict_fn returned host arrays, so the span ends at the
            # result; real rows are "prefill" positions, the pow2 pad rows
            # the waste token_efficiency shows; no row ownership here
            self.ledger.book_dispatch(
                self.clock.now() - tc0, prefill_positions=total,
                decode_positions=0, total_positions=padded, owners=())
        # un-pad, then split batched outputs by request row counts
        trimmed = []
        for o in outs:
            o = np.asarray(o)
            if padded != total and o.ndim >= 1 and o.shape[0] == padded:
                o = o[:total]
            trimmed.append(o)
        now = self.clock.now()
        offset = 0
        for r in batch:
            result = []
            for o in trimmed:
                if o.ndim >= 1 and o.shape[0] == total:
                    result.append(o[offset:offset + r.rows])
                else:  # non-batched output (constant/state table)
                    result.append(o)
            offset += r.rows
            # finalize the trace BEFORE resolving the future: a waiter
            # unblocked by set_result must find the completed timeline
            self._conclude(r, "completed", now)
            r.future.set_result(result)
            self.metrics.on_complete((now - r.arrival) * 1e3)
        with self._cond:
            depth = len(self._pending)
        self.metrics.on_dispatch(total, len(batch), padded,
                                 (now - t0) * 1e3, depth)

    # ---- scheduler thread (production mode) ----
    def _scheduler_main(self):
        cfg = self.config
        while True:
            with self._cond:
                while True:
                    if self._stopped:
                        return
                    if self._draining and not self._pending:
                        return          # drained: stop() joins us
                    if self._pending:
                        now = self.clock.now()
                        total = sum(r.rows for r in self._pending)
                        wake = self._pending[0].arrival + cfg.max_wait_ms / 1e3
                        for r in self._pending:
                            if r.deadline is not None:
                                wake = min(wake, r.deadline)
                        if (total >= cfg.max_batch_size or now >= wake
                                or self._draining):
                            break
                        self.clock.wait(self._cond, max(0.0, wake - now))
                    else:
                        self.clock.wait(self._cond, None)
            try:
                self.pump()
            except Exception as e:
                # _dispatch already routes per-batch errors to the batch's
                # futures; anything escaping pump() is a scheduler bug. Log
                # and keep scheduling — a dead scheduler would wedge every
                # queued and future request until their own timeouts.
                _log.exception("serving scheduler pump failed; continuing")
                fr = flight_recorder()
                fr.record("pump_exception", engine="serving",
                          error=f"{type(e).__name__}: {e}")
                fr.try_dump(reason="pump_exception:serving")
