"""Black-box flight recorder (counterpart of
paddle_tpu/obs/flight_recorder.py): a process-global, lock-protected
bounded ring of structured events fed by the resilient trainer and the
checkpoint managers (NaN rollbacks, retries, checkpoint snapshots,
persists, drops and quarantines, preemption).

The ring is always on (the fed events are rare: failures and
transitions, never per-step hot-path work) and is dumped atomically
(write tmp, fsync, os.replace: the checkpoint manifest's torn-write
discipline) when something goes badly wrong: SIGTERM, an OOM, or on
demand. The dump is the JAX package's format, so its postmortem tool
(`tools/flight_recorder.py`) reads the port's dumps too. Stdlib only.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Optional

# directory for automatic dumps (breaker-open / SIGTERM / pump crash);
# falls back to the system tempdir when unset
DUMP_DIR_ENV = "PDTPU_FLIGHT_DIR"
DUMP_VERSION = 1


class FlightRecorder:
    """Bounded ring of {"seq", "t_mono", "t_wall", "kind", ...} events."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dumps = 0

    def record(self, kind: str, **info) -> dict:
        evt = dict(info)
        evt["kind"] = str(kind)
        evt["t_mono"] = time.monotonic()
        evt["t_wall"] = time.time()
        with self._lock:
            evt["seq"] = self._seq
            self._seq += 1
            self._ring.append(evt)
        return evt

    def snapshot(self) -> dict:
        with self._lock:
            events = list(self._ring)
            recorded = self._seq
        return {"version": DUMP_VERSION, "capacity": self.capacity,
                "recorded": recorded, "dropped": recorded - len(events),
                "events": events}

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seq = 0

    def default_dump_path(self) -> str:
        d = os.environ.get(DUMP_DIR_ENV) or tempfile.gettempdir()
        return os.path.join(d, f"pdtpu_flight_{os.getpid()}.json")

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Atomic torn-write-safe dump; returns the final path."""
        doc = self.snapshot()
        doc.update(reason=reason, pid=os.getpid(), dumped_at=time.time())
        if path is None:
            path = self.default_dump_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            self.dumps += 1
        return path

    def try_dump(self, path: Optional[str] = None,
                 reason: str = "manual") -> Optional[str]:
        """dump() that never raises — for signal handlers and except
        blocks where the dump must not mask the original failure."""
        try:
            return self.dump(path=path, reason=reason)
        except Exception:
            return None


_GLOBAL = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder every subsystem feeds."""
    return _GLOBAL
