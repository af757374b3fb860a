"""Profiler (counterpart of paddle_tpu/profiler/__init__.py; reference:
paddle/fluid/platform/profiler.h RecordEvent/EnableProfiler,
python/paddle/fluid/profiler.py).

Host spans are recorded in-process (RecordEvent parity) with the JAX
package's event dicts, so one chrome export holds the spans, the
`record_instant` fault markers and the goodput lanes of both packages
alike. Device profiling goes to `torch.profiler` (CUPTI) where the JAX
package uses its own profiler (xprof): `start_profiler(trace_dir=...)`
and `Profiler` write a chrome trace of the device timeline into the
trace directory when they stop (`torch_trace_<pid>.json`).

The event sink is PROCESS-GLOBAL: the checkpoint writer thread, a
prefetcher's thread and the training loop all append to one shared
buffer under a lock, so whichever thread calls `export_chrome_tracing`
sees every span. Only the span *stack* (nesting context) stays
per-thread. The disabled hot path is a single predicate: no lock is
taken unless profiling is on. `profiler/cross_stack.py` waits for its
own slice (ROADMAP §1 item 9).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional


class _ProfSink:
    """Shared event buffer. `enabled` is read without the lock (a stale
    read drops or records one extra event, never corrupts the buffer);
    all appends/reads of `events` and `trace_dir` hold `lock`."""

    __slots__ = ("lock", "enabled", "events", "trace_dir", "device")

    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.events: List[dict] = []
        self.trace_dir: Optional[str] = None
        self.device = None     # the running torch.profiler session


_SINK = _ProfSink()


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: List[str] = []


_T = _ThreadState()


class RecordEvent:
    """RAII host span (platform/profiler.h:127 analog)."""

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.begin = None

    def __enter__(self):
        self.begin = time.perf_counter_ns()
        _T.stack.append(self.name)
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self):
        if _T.stack and _T.stack[-1] == self.name:
            _T.stack.pop()
        if self.begin is None or not _SINK.enabled:
            self.begin = None
            return
        evt = {
            "name": self.name, "ts": self.begin / 1e3,
            "dur": (time.perf_counter_ns() - self.begin) / 1e3,
            "ph": "X", "pid": 0, "tid": threading.get_ident() % 10000,
        }
        self.begin = None
        with _SINK.lock:
            _SINK.events.append(evt)


def record_instant(name: str, args: Optional[dict] = None):
    """Zero-duration instant event (chrome 'i' phase) — used for fault /
    recovery markers (resilient runtime) so they land on the same timeline
    as the step spans."""
    if not _SINK.enabled:
        return
    evt = {
        "name": name, "ts": time.perf_counter_ns() / 1e3,
        "ph": "i", "s": "p", "pid": 0,
        "tid": threading.get_ident() % 10000,
        "args": args or {},
    }
    with _SINK.lock:
        _SINK.events.append(evt)


def emit_events(events: List[dict]):
    """Append pre-built chrome events (e.g. the phase lanes of
    obs.goodput) onto the shared timeline."""
    if not _SINK.enabled or not events:
        return
    with _SINK.lock:
        _SINK.events.extend(events)


def profiler_enabled() -> bool:
    return _SINK.enabled


def _start_device_trace():
    """A running torch.profiler session over the host and, when a card is
    present, the device (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_device_trace(prof, trace_dir: str) -> str:
    """Stop `prof` and write its chrome trace into `trace_dir`."""
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"torch_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def start_profiler(state="All", tracer_option="Default", trace_dir=None):
    with _SINK.lock:
        _SINK.events.clear()
        # module-global, NOT thread-local: stop_profiler() from any thread
        # must see the trace_dir that start_profiler() armed
        _SINK.trace_dir = trace_dir or None
    _SINK.enabled = True
    if trace_dir:
        _SINK.device = _start_device_trace()


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    _SINK.enabled = False
    with _SINK.lock:
        trace_dir, _SINK.trace_dir = _SINK.trace_dir, None
        device, _SINK.device = _SINK.device, None
    if trace_dir and device is not None:
        _stop_device_trace(device, trace_dir)
    export_chrome_tracing(profile_path)


def export_chrome_tracing(path: str):
    with _SINK.lock:
        events = list(_SINK.events)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile",
             tracer_option="Default"):
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class Profiler:
    """paddle.profiler.Profiler-style API over torch.profiler."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, trace_dir="/tmp/paddle_tpu_trace"):
        self.trace_dir = trace_dir
        self.timer_only = timer_only
        self._device = None

    def start(self):
        with _SINK.lock:
            _SINK.events.clear()
        _SINK.enabled = True
        if not self.timer_only:
            self._device = _start_device_trace()

    def stop(self):
        _SINK.enabled = False
        if self._device is not None:
            _stop_device_trace(self._device, self.trace_dir)
            self._device = None

    def step(self, num_samples=None):
        pass

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        by_name: Dict[str, List[float]] = {}
        # only complete ("X") spans carry a duration; instants ("i") from
        # record_instant share the buffer and must not crash the summary
        for e in get_events():
            if e.get("ph") != "X":
                continue
            by_name.setdefault(e["name"], []).append(e["dur"])
        lines = [f"{'Event':40s} {'Calls':>8s} {'Total(us)':>12s} {'Avg(us)':>12s}"]
        for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
            lines.append(f"{name:40s} {len(durs):8d} {sum(durs):12.1f} "
                         f"{sum(durs)/len(durs):12.1f}")
        return "\n".join(lines)


class ThroughputTracker:
    """Per-chunk wall-time → steps/sec and tokens/sec.

    The chunk run loop (trainer.DeviceWorker over a parallel.ScanTrainStep)
    calls `update(steps=K, seconds=dt, tokens=K*B*S)` once per fused
    dispatch, so utilization is reported from the production path without a
    separate bench run. Rates are computed over a sliding window of recent
    chunks (warmup/compile chunks age out) alongside lifetime totals; each
    update also drops a `throughput` instant on the profiler timeline when
    profiling is enabled.
    """

    def __init__(self, window: int = 32):
        from collections import deque
        self.window = int(window)
        self._chunks = deque(maxlen=self.window)  # (steps, tokens, seconds)
        self.total_steps = 0
        self.total_tokens = 0
        self.total_seconds = 0.0
        # duration of the most recent chunk — the watchdog and the goodput
        # ledger read the same step-duration signal the rates use
        self.last_chunk_seconds = 0.0
        self._flops_per_step: Optional[float] = None
        self._peak_flops: Optional[float] = None

    def register_flops(self, flops_per_step: float, peak_flops: float):
        """Arm the windowed MFU gauge: analytic FLOPs per step (see
        obs.flops) and the mesh's TOTAL peak FLOP/s."""
        self._flops_per_step = float(flops_per_step)
        self._peak_flops = float(peak_flops)

    def update(self, steps: int, seconds: float, tokens: int = 0):
        steps, tokens, seconds = int(steps), int(tokens), float(seconds)
        self.last_chunk_seconds = seconds
        # a zero/negative-duration chunk flood (mocked clocks, duplicate
        # timestamps) must not age real measurements out of the rate
        # window; totals still count the work
        if seconds > 0.0:
            self._chunks.append((steps, tokens, seconds))
        self.total_steps += steps
        self.total_tokens += tokens
        self.total_seconds += seconds
        record_instant("throughput", {
            "steps": steps, "tokens": tokens, "seconds": seconds,
            "steps_per_sec": self.steps_per_sec,
            "tokens_per_sec": self.tokens_per_sec,
        })

    def _windowed(self, idx: int) -> float:
        secs = sum(c[2] for c in self._chunks)
        if secs <= 0.0:
            return 0.0
        return sum(c[idx] for c in self._chunks) / secs

    @property
    def steps_per_sec(self) -> float:
        return self._windowed(0)

    @property
    def tokens_per_sec(self) -> float:
        return self._windowed(1)

    @property
    def mfu(self) -> Optional[float]:
        """Windowed model-FLOPs utilization, or None until
        register_flops() arms the gauge."""
        if self._flops_per_step is None or not self._peak_flops:
            return None
        return self.steps_per_sec * self._flops_per_step / self._peak_flops

    def summary(self) -> dict:
        out = {
            "steps_per_sec": self.steps_per_sec,
            "tokens_per_sec": self.tokens_per_sec,
            "total_steps": self.total_steps,
            "total_tokens": self.total_tokens,
            "total_seconds": self.total_seconds,
            "last_chunk_seconds": self.last_chunk_seconds,
        }
        if self._flops_per_step is not None:
            out["mfu"] = self.mfu
        return out


def get_events():
    with _SINK.lock:
        return list(_SINK.events)
