"""Per-request tracing (counterpart of paddle_tpu/obs/trace.py): a
`traceparent`-style request id ingested (or generated) at the HTTP layer
and a structured timeline accumulated as the request moves through an
engine: admission, queue wait, dispatch.

Cost discipline: a request that did not opt in carries `trace=None`, so
every hot-path hook is one predicate (`if req.trace is not None`). All
timestamps are the owning engine's `clock.now()` seconds, so SimClock
tests get deterministic timelines and MonotonicClock timelines interleave
with `RecordEvent` spans (both CLOCK_MONOTONIC) in the chrome export.

The derived phase spans TILE the request's lifetime: their durations sum
exactly to the recorded latency. `BatchingEngine` and `LLMEngine`
(`submit(trace=True)`) record these timelines.
"""
from __future__ import annotations

import re
import threading
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..profiler import emit_events

# W3C trace-context: version "-" 32-hex trace-id "-" 16-hex span-id "-" flags
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}$")

# phase name -> the mark that *starts* it; a phase ends where the next
# present phase starts (or at "finished"). Order matters.
LLM_PHASES: Tuple[Tuple[str, str], ...] = (
    ("queued", "submitted"), ("prefill", "admitted"),
    ("decode", "first_token"))
SERVING_PHASES: Tuple[Tuple[str, str], ...] = (
    ("queued", "submitted"), ("dispatch", "dispatched"))


def new_request_id() -> str:
    return uuid.uuid4().hex


def ingest_traceparent(header: Optional[str]) -> Optional[str]:
    """Extract the 32-hex trace-id from a `traceparent` header value."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    return m.group(1) if m else None


class RequestTrace:
    """Timeline of one request: named marks (phase boundaries, recorded at
    most once) plus a bounded list of fine-grained events."""

    MAX_EVENTS = 512

    __slots__ = ("rid", "slo", "tenant", "phase_defs", "marks", "events",
                 "dropped", "outcome", "_lock")

    def __init__(self, rid: str, t0: float, slo: Optional[str] = None,
                 tenant: Optional[str] = None,
                 phase_defs: Sequence[Tuple[str, str]] = LLM_PHASES):
        self.rid = rid
        self.slo = slo
        self.tenant = tenant
        self.phase_defs = tuple(phase_defs)
        self.marks: Dict[str, float] = {"submitted": float(t0)}
        self.events: List[dict] = []
        self.dropped = 0
        self.outcome: Optional[str] = None
        self._lock = threading.Lock()

    def mark(self, name: str, t: float):
        with self._lock:
            self.marks.setdefault(name, float(t))

    def event(self, name: str, t: float, **args):
        with self._lock:
            if len(self.events) >= self.MAX_EVENTS:
                self.dropped += 1
                return
            e = {"name": name, "t": float(t)}
            if args:
                e["args"] = args
            self.events.append(e)

    def finish(self, t: float, outcome: str):
        with self._lock:
            self.marks.setdefault("finished", float(t))
            if self.outcome is None:
                self.outcome = outcome

    # ---- derived views ----
    def phases(self) -> List[dict]:
        """Contiguous phase spans tiling [submitted, finished] — the span
        durations sum exactly to the recorded latency."""
        with self._lock:
            marks = dict(self.marks)
            defs = self.phase_defs
        end = marks.get("finished")
        if end is None:
            return []
        starts = [(name, marks[mk]) for name, mk in defs if mk in marks]
        out = []
        for i, (name, t_start) in enumerate(starts):
            t_end = starts[i + 1][1] if i + 1 < len(starts) else end
            out.append({"name": name, "start": t_start, "end": t_end})
        return out

    def to_dict(self) -> dict:
        with self._lock:
            marks = dict(self.marks)
            events = [dict(e) for e in self.events]
            dropped = self.dropped
            outcome = self.outcome
        t0 = marks["submitted"]
        tend = marks.get("finished")
        doc = {
            "rid": self.rid, "slo": self.slo, "tenant": self.tenant,
            "outcome": outcome,
            "marks_ms": {k: (v - t0) * 1e3 for k, v in marks.items()},
            "latency_ms": None if tend is None else (tend - t0) * 1e3,
            "ttft_ms": (None if "first_token" not in marks
                        else (marks["first_token"] - t0) * 1e3),
            "phases": [{"name": p["name"],
                        "start_ms": (p["start"] - t0) * 1e3,
                        "dur_ms": (p["end"] - p["start"]) * 1e3}
                       for p in self.phases()],
            "events": [{"name": e["name"], "t_ms": (e["t"] - t0) * 1e3,
                        **({"args": e["args"]} if "args" in e else {})}
                       for e in events],
            "events_dropped": dropped,
        }
        return doc

    def chrome_events(self) -> List[dict]:
        """Chrome-trace view: one 'X' span per phase plus 'i' instants for
        the fine events, on a per-request lane so concurrent requests
        don't stack."""
        tid = int(self.rid[:6], 16) % 10000 if self.rid else 0
        out = []
        for p in self.phases():
            out.append({"name": f"req/{self.rid[:8]}/{p['name']}",
                        "ts": p["start"] * 1e6,
                        "dur": (p["end"] - p["start"]) * 1e6,
                        "ph": "X", "pid": 0, "tid": tid,
                        "args": {"rid": self.rid}})
        with self._lock:
            events = [dict(e) for e in self.events]
        for e in events:
            out.append({"name": f"req/{self.rid[:8]}/{e['name']}",
                        "ts": e["t"] * 1e6, "ph": "i", "s": "t",
                        "pid": 0, "tid": tid,
                        "args": dict(e.get("args") or {}, rid=self.rid)})
        return out

    def emit_chrome(self):
        """Append this request's spans onto the shared profiler sink (a
        no-op unless profiling is enabled) so request timelines interleave
        with RecordEvent training/serving spans."""
        emit_events(self.chrome_events())


class TimelineStore:
    """Bounded LRU of recent finished timelines, keyed by request id —
    backs the `/debug/requests/<rid>` endpoint."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._items: "OrderedDict[str, dict]" = OrderedDict()

    def put(self, rid: str, timeline: dict):
        with self._lock:
            self._items.pop(rid, None)
            self._items[rid] = timeline
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)

    def get(self, rid: str) -> Optional[dict]:
        with self._lock:
            tl = self._items.get(rid)
            if tl is not None:
                self._items.move_to_end(rid)
            return tl

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
