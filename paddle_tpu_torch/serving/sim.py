"""Deterministic simulation harness for the batching engine (counterpart
of paddle_tpu/serving/sim.py).

Scripted arrival traces replayed against a `SimClock`-driven, threadless
engine: the harness advances the clock to each scheduler-relevant instant
(arrival, max_wait flush, deadline expiry) and calls `engine.pump()`
there. No real sleeps, no scheduler thread: the production scheduler
(`BatchingEngine.pump`) runs at exact instants, so a trace's dispatches
are countable facts, and the same trace replayed through both packages'
engines gives the same dispatches.

    clock = SimClock()
    engine = BatchingEngine(fn, EngineConfig(max_batch_size=8), clock=clock)
    report = replay(engine, poisson_trace(64, rate_hz=2000, make_inputs=mk))
    assert report.dispatches <= 9
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from .clock import SimClock
from .engine import BatchingEngine, RejectedError


@dataclass
class Arrival:
    t: float                      # seconds on the engine clock
    inputs: list                  # per-request input arrays (leading dim)
    deadline_ms: Optional[float] = None


def poisson_trace(n: int, rate_hz: float, make_inputs: Callable[[int], list],
                  seed: int = 0, deadline_ms: Optional[float] = None
                  ) -> List[Arrival]:
    """Seeded exponential inter-arrivals — deterministic 'open-loop' load."""
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate_hz))
        out.append(Arrival(t=t, inputs=make_inputs(i),
                           deadline_ms=deadline_ms))
    return out


def uniform_trace(n: int, interval_s: float,
                  make_inputs: Callable[[int], list],
                  deadline_ms: Optional[float] = None) -> List[Arrival]:
    return [Arrival(t=i * interval_s, inputs=make_inputs(i),
                    deadline_ms=deadline_ms) for i in range(n)]


@dataclass
class ReplayReport:
    outcomes: List[str] = field(default_factory=list)  # per arrival, in order
    results: List[Optional[list]] = field(default_factory=list)
    errors: List[Optional[BaseException]] = field(default_factory=list)
    dispatches: int = 0
    metrics: dict = field(default_factory=dict)

    @property
    def completed(self) -> int:
        return self.outcomes.count("completed")

    @property
    def rejected(self) -> int:
        return self.outcomes.count("rejected")

    @property
    def expired(self) -> int:
        return self.outcomes.count("expired")


def replay(engine: BatchingEngine, arrivals: Sequence[Arrival],
           settle_s: float = 1.0) -> ReplayReport:
    """Drive `engine` (threadless, sharing a SimClock) through the trace.

    Between consecutive arrivals the clock stops at every due flush/deadline
    instant and pumps there — exactly what the scheduler thread's condition
    timeout does in production. After the last arrival the engine is drained
    (`stop(drain=True)`) and the report collects every future's outcome.
    """
    clock = engine.clock
    if not isinstance(clock, SimClock):
        raise TypeError("replay() needs the engine on a SimClock; got "
                        f"{type(clock).__name__}")
    report = ReplayReport()
    futures = []
    for a in sorted(arrivals, key=lambda x: x.t):
        # fire time-driven scheduler actions due strictly before this arrival
        while True:
            nxt = engine.next_event_time()
            if nxt is None or nxt > a.t:
                break
            clock.advance_to(nxt)
            report.dispatches += engine.pump()
        clock.advance_to(a.t)
        try:
            futures.append(engine.submit(a.inputs,
                                         deadline_ms=a.deadline_ms))
        except RejectedError as e:
            futures.append(e)
        report.dispatches += engine.pump()  # size-triggered flush, same t
    # drain the tail: run out the remaining flush/deadline instants, then
    # a final settle window so nothing is left pending
    while True:
        nxt = engine.next_event_time()
        if nxt is None:
            break
        clock.advance_to(nxt)
        report.dispatches += engine.pump()
    clock.advance(settle_s)
    engine.stop(drain=True)

    for fut in futures:
        if isinstance(fut, RejectedError):
            report.outcomes.append("rejected")
            report.results.append(None)
            report.errors.append(fut)
            continue
        exc = fut.exception(timeout=0)
        if exc is None:
            report.outcomes.append("completed")
            report.results.append(fut.result(timeout=0))
            report.errors.append(None)
        else:
            from .engine import DeadlineExceededError
            report.outcomes.append(
                "expired" if isinstance(exc, DeadlineExceededError)
                else "failed")
            report.results.append(None)
            report.errors.append(exc)
    report.metrics = engine.metrics.snapshot()
    return report
