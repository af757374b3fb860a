"""Injectable clocks for the serving engine (the port's own copy of the
parts of paddle_tpu/serving/clock.py it uses; that module imports no JAX,
but the port imports nothing of the JAX package).

The scheduler's flush/deadline decisions are pure functions of "now", so
swapping the time source makes the whole batching engine deterministic:
`MonotonicClock` is production, `SimClock` is a manually-advanced clock a
test or the simulation harness (serving/sim.py) drives through scripted
arrival traces — no real sleeps, no wall-clock flake in tests.
"""
from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        """Seconds on this clock's timeline (monotonic)."""
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout) -> None:
        """Block the scheduler thread on `cond` (held) for up to `timeout`
        seconds (None = until notified)."""
        raise NotImplementedError


class MonotonicClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def wait(self, cond, timeout):
        cond.wait(timeout)


class SimClock(Clock):
    """Scripted time. `wait` never sleeps: under a SimClock the engine runs
    threadless — the harness advances the clock and calls `engine.pump()`
    itself, so every flush decision happens at an exact scripted instant."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"SimClock cannot go backwards (dt={dt})")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t

    def wait(self, cond, timeout):
        # notified or not, simulated waiting is the harness's job
        return
