"""Engine supervision: hung-dispatch watchdog and circuit breaker
(counterpart of paddle_tpu/serving/supervisor.py).

Every prefill/decode/predict dispatch of the serving engines runs through
`EngineSupervisor.run()`, which

- converts any exception the dispatch raises into a typed
  `DispatchFailedError`, so the engines route a classified failure to the
  implicated futures instead of a bare model exception;
- bounds the dispatch's wall time with a deadline thread when
  `dispatch_timeout_s` is set: a dispatch that does not return within the
  budget becomes a `DispatchHungError` and its worker thread is abandoned
  (a daemon; nothing can interrupt a thread waiting inside a CUDA call).
  What an abandoned attempt may still do to shared state is the engine's
  to fence: `LLMEngine` revokes the attempt's KV write token before it
  retries (serving/llm/llm_engine.py);
- keeps the engine-level circuit breaker: `record_failure()` counts
  CONSECUTIVE engine-level failures (a whole failure protocol exhausting
  its retries, not a single raised dispatch); at `breaker_threshold` the
  breaker opens for good, with no half-open probe: the contract is "stop
  admitting and drain so that a supervisor replaces the process".
  `absolve()` resets the count when a failure was attributed to one
  request (quarantine): a poisoned request never takes the engine down.

Injected hangs (`dispatch_hang@N` in utils/fault_injection) arrive as
`InjectedDispatchHang` and take the same `DispatchHungError` path without
any real sleeping, so SimClock tests prove the protocol threadlessly; the
deadline thread itself is exercised by wall-clock tests.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from ..obs.flight_recorder import flight_recorder
from ..utils.fault_injection import InjectedDispatchHang

_log = logging.getLogger("paddle_tpu_torch.serving")


class DispatchFailedError(RuntimeError):
    """A supervised dispatch raised. `reason` classifies it for metrics
    and HTTP mapping: "raise" (the dispatch errored), "hang" (watchdog
    fired), "poisoned" (failure attributed to one request after retries),
    "engine" (engine-level protocol exhaustion failed this request)."""

    def __init__(self, msg: str, reason: str = "raise"):
        super().__init__(msg)
        self.reason = reason


class DispatchHungError(DispatchFailedError):
    """The dispatch exceeded the watchdog budget and was abandoned."""

    def __init__(self, msg: str):
        super().__init__(msg, reason="hang")


class EngineSupervisor:
    """Per-engine dispatch watchdog and consecutive-failure breaker.

    `run(fn, label)` executes one dispatch attempt under supervision.
    `record_failure()` / `record_success()` / `absolve()` drive the
    breaker at protocol granularity (the engine decides what counts as an
    engine-level failure). `on_trip` fires exactly once, from whichever
    thread tripped the breaker.
    """

    def __init__(self, dispatch_timeout_s: Optional[float] = None,
                 breaker_threshold: int = 3,
                 on_trip: Optional[Callable[[], None]] = None,
                 name: str = "engine"):
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self.dispatch_timeout_s = dispatch_timeout_s
        self.breaker_threshold = int(breaker_threshold)
        self.on_trip = on_trip
        self.name = name
        self._lock = threading.Lock()
        self._consecutive = 0
        self._open = False
        self.stats: Dict[str, int] = {
            "dispatch_failures": 0, "watchdog_fires": 0,
            "breaker_trips": 0, "quarantines": 0, "exempt_failures": 0,
        }

    # ---- supervised dispatch ----
    def run(self, fn: Callable, label: str = "dispatch",
            exempt: bool = False):
        """One supervised dispatch attempt. Returns fn()'s result or
        raises DispatchFailedError / DispatchHungError, never the raw
        model exception, and never blocks past the watchdog budget.

        `exempt=True` marks a best-effort auxiliary dispatch: its failures
        are typed and recorded but land in the "exempt_failures" stat, so
        accounting built on "dispatch_failures" never sees them."""
        try:
            if self.dispatch_timeout_s is None:
                return fn()
            return self._run_deadlined(fn, label)
        except DispatchFailedError:
            raise
        except InjectedDispatchHang as e:
            with self._lock:
                self.stats["watchdog_fires"] += 1
            flight_recorder().record(
                "dispatch_hang", engine=self.name, label=label,
                seconds=e.seconds, exempt=exempt)
            budget = (f"{self.dispatch_timeout_s:.1f}s watchdog budget"
                      if self.dispatch_timeout_s is not None
                      else "no watchdog configured — a real hang would "
                           "block forever")
            raise DispatchHungError(
                f"{self.name} {label} dispatch hung "
                f"(injected {e.seconds:.1f}s; {budget})") from e
        except Exception as e:
            with self._lock:
                self.stats["exempt_failures" if exempt
                           else "dispatch_failures"] += 1
            flight_recorder().record(
                "dispatch_failure", engine=self.name, label=label,
                error=f"{type(e).__name__}: {e}", exempt=exempt)
            raise DispatchFailedError(
                f"{self.name} {label} dispatch failed: "
                f"{type(e).__name__}: {e}") from e

    def _run_deadlined(self, fn: Callable, label: str):
        """Run fn on a deadline thread. On timeout the worker is abandoned
        (a daemon: it never outlives the process the breaker recycles)."""
        box: dict = {}
        done = threading.Event()

        def worker():
            try:
                box["value"] = fn()
            except BaseException as e:   # delivered to the caller below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True,
                             name=f"pdtt-{self.name}-dispatch")
        t.start()
        if not done.wait(self.dispatch_timeout_s):
            with self._lock:
                self.stats["watchdog_fires"] += 1
            flight_recorder().record(
                "dispatch_hang", engine=self.name, label=label,
                seconds=self.dispatch_timeout_s)
            raise DispatchHungError(
                f"{self.name} {label} dispatch exceeded the "
                f"{self.dispatch_timeout_s:.1f}s watchdog budget; "
                "abandoning the worker thread")
        if "error" in box:
            raise box["error"]
        return box["value"]

    # ---- circuit breaker (engine-level failure accounting) ----
    def record_failure(self) -> bool:
        """One engine-level failure (a whole protocol exhausted its
        retries). Returns True when this call tripped the breaker open."""
        tripped = False
        with self._lock:
            self._consecutive += 1
            if not self._open and self._consecutive >= self.breaker_threshold:
                self._open = True
                self.stats["breaker_trips"] += 1
                tripped = True
        if tripped:
            _log.error(
                "%s circuit breaker OPEN after %d consecutive engine-level "
                "failures; engine stops admitting and should be drained",
                self.name, self.breaker_threshold)
            # the black-box dump comes before the drain callback, so the
            # postmortem holds the run-up even if the drain wedges
            fr = flight_recorder()
            fr.record("breaker_open", engine=self.name,
                      threshold=self.breaker_threshold)
            fr.try_dump(reason=f"breaker_open:{self.name}")
            if self.on_trip is not None:
                try:
                    self.on_trip()
                except Exception:
                    _log.exception("%s on_trip callback failed", self.name)
        return tripped

    def record_success(self):
        with self._lock:
            self._consecutive = 0

    def absolve(self):
        """The failure streak was attributed to one request (quarantined):
        reset the breaker, since a poisoned request is not an engine
        fault."""
        with self._lock:
            self.stats["quarantines"] += 1
            self._consecutive = 0
        flight_recorder().record("breaker_absolved", engine=self.name)

    @property
    def open(self) -> bool:
        with self._lock:
            return self._open

    def snapshot(self) -> dict:
        with self._lock:
            return {**self.stats, "circuit_open": self._open,
                    "consecutive_failures": self._consecutive}
