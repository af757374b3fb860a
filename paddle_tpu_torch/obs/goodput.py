"""Training goodput ledger (counterpart of paddle_tpu/obs/goodput.py):
where did the wall clock go?

Every second of trainer wall time is attributed to exactly ONE phase:

- ``compute``        — productive device work (the chunk's launches plus
                       the blocking loss read);
- ``rollback_waste`` — device work re-running steps a rollback already
                       completed once, and retry-backoff sleeps;
- ``data_wait``      — the consumer blocked on ChunkPrefetcher starvation
                       (the producer thread's stacking and staging is NOT
                       booked: overlapping it with compute is the point);
- ``h2d``            — host→device staging on the caller thread
                       (ScanTrainStep.__call__ without a prefetcher);
- ``compile``        — building the kernel library (the port's only
                       compile), reported by the recompile sentinel and
                       subtracted from the enclosing phase;
- ``checkpoint``     — CheckpointManager save/restore, snapshot fetches;
- ``idle``           — the residual: wall minus everything booked.

The invariant — phase seconds tile measured wall clock — holds by
construction: `measure()` frames nest on a per-thread stack and each
books only its SELF time (span minus inner frames and inner `book()`
charges), and `idle` is defined as the unbooked residual, clamped at
zero.

On top of the ledger:

- **live MFU** — `flops_per_step x productive_steps / wall / peak`,
  with the FLOPs arithmetic from the port's obs.flops;
- **RecompileSentinel** — where the JAX sentinel counts XLA compiles,
  this one counts builds of the kernel library (`ops._kernels`
  build listeners: the nvcc build at first use; loading a library
  already built is no compile), books their seconds as `compile`, and
  treats a build after ``mark_warm()`` as a recompile: each drops a
  ``train_recompile`` flight-recorder event and a storm (>=
  storm_threshold) logs a warning;
- **HBMTelemetry** — the caching allocator's watermarks
  (`torch.cuda.memory_stats()`, mapped to the JAX key names
  ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``) with
  params/opt-state attribution, and ``oom_forensics``, which turns a
  `torch.cuda.OutOfMemoryError` into a ``train_oom`` flight event plus
  an atomic black-box dump.

Cost discipline: a trainer built without the ledger pays exactly one
predicate per hook (`if ledger is not None:`) — no clock read, no
allocation, no lock.

Module import stays stdlib-only; torch and the kernel loader are
imported lazily inside ``RecompileSentinel.install`` / the default HBM
stats fn / ``oom_forensics``.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from .flight_recorder import flight_recorder

_log = logging.getLogger("paddle_tpu_torch.goodput")

# attribution order is the chrome-trace lane order
PHASES = ("compute", "rollback_waste", "data_wait", "h2d", "compile",
          "checkpoint", "idle")

# where compiles come from: the kernel library's build
SOURCES = ("kernel_build",)


class PhaseLedger:
    """Exclusive phase attribution over wall clock — the shared frame
    bookkeeping under the training `GoodputLedger` (the JAX package's
    serving ledger builds on it too).

    `measure(phase)` frames nest on a per-thread stack; a frame books
    its span MINUS the time inner frames (and inner `book()` charges)
    already claimed, so nested hooks never double-count. `book(phase,
    secs)` attributes time reported from callbacks (compile durations,
    per-dispatch splits) and charges it against the enclosing frame the
    same way. The clock is injectable for deterministic tests.

    Subclasses set `phases` (must end with "idle", the unbooked
    residual) and `lane_prefix` (the chrome-trace lane family, e.g.
    `goodput/<phase>` / `serving/<phase>`).
    """

    phases: tuple = ("busy", "idle")
    lane_prefix: str = "phase"

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._phase_seconds: Dict[str, float] = {
            p: 0.0 for p in self.phases if p != "idle"}
        self._tls = threading.local()

    # ---- lifecycle ----
    def start(self):
        """Arm the wall clock; idempotent (first measure/book auto-arms)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self._clock()

    def reset(self):
        """Zero the booked phases and re-arm the wall clock at `now` (when
        already armed) — excludes warmup from a measurement window."""
        with self._lock:
            for p in self._phase_seconds:
                self._phase_seconds[p] = 0.0
            if self._t0 is not None:
                self._t0 = self._clock()
            self._reset_extra_locked()

    def _reset_extra_locked(self):
        """Subclass hook: zero per-subclass counters under the lock."""

    # ---- attribution ----
    def _stack(self) -> List[list]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @contextlib.contextmanager
    def measure(self, phase: str):
        """Attribute the enclosed span's SELF time to `phase`."""
        self.start()
        stack = self._stack()
        frame = [phase, self._clock(), 0.0]  # [phase, t_in, inner_seconds]
        stack.append(frame)
        try:
            yield self
        finally:
            stack.pop()
            t_out = self._clock()
            span = t_out - frame[1]
            with self._lock:
                self._phase_seconds[phase] += max(span - frame[2], 0.0)
            if stack:  # the whole span is inner time for the parent
                stack[-1][2] += span
            _emit_chrome_span(f"{self.lane_prefix}/{phase}",
                              frame[1], t_out)

    def book(self, phase: str, seconds: float):
        """Attribute externally-measured seconds (e.g. a compile duration
        reported by the sentinel while a compute measure is open); the
        enclosing frame's self time shrinks by the same amount."""
        seconds = max(float(seconds), 0.0)
        self.start()
        with self._lock:
            self._phase_seconds[phase] += seconds
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1][2] += seconds

    # ---- reporting ----
    def wall_and_phases(self) -> tuple:
        """(wall_seconds, {phase: seconds}) with idle = the clamped
        unbooked residual — the tiling invariant both subclasses build
        their snapshots on."""
        now = self._clock()
        with self._lock:
            phases = dict(self._phase_seconds)
            t0 = self._t0
        wall = (now - t0) if t0 is not None else 0.0
        booked = sum(phases.values())
        phases["idle"] = max(wall - booked, 0.0)
        return wall, phases


class GoodputLedger(PhaseLedger):
    """Training-phase attribution over trainer wall clock, plus the
    step/FLOPs accounting that turns it into goodput and live MFU."""

    phases = PHASES
    lane_prefix = "goodput"

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        super().__init__(clock=clock)
        self.productive_steps = 0
        self.wasted_steps = 0
        self.flops_per_step: Optional[float] = None
        self.peak_flops_total: Optional[float] = None
        # seconds the AsyncCheckpointManager writer thread spent
        # persisting snapshots. Deliberately NOT a phase — the writer runs
        # concurrently with the step loop on its own thread, so booking it
        # into phase_seconds would break the phases-tile-wall invariant.
        # The `checkpoint` PHASE is therefore the BLOCKING cost only
        # (host-fetch snapshot + sync saves/restores), and blocking vs
        # async-background is directly comparable in snapshot().
        self.checkpoint_async_seconds = 0.0

    def set_flops(self, flops_per_step: float, peak_flops_total: float):
        """Register the analytic FLOPs (obs.flops helpers) and the mesh's
        total peak so snapshot() can report live MFU."""
        self.flops_per_step = float(flops_per_step)
        self.peak_flops_total = float(peak_flops_total)

    def add_steps(self, k: int, productive: bool = True):
        """Count optimizer steps; re-run steps after a rollback are waste."""
        with self._lock:
            if productive:
                self.productive_steps += int(k)
            else:
                self.wasted_steps += int(k)

    def book_async_checkpoint(self, seconds: float):
        """Background-writer persist seconds (AsyncCheckpointManager):
        overlapped work, counted beside — never inside — the phases."""
        with self._lock:
            self.checkpoint_async_seconds += max(float(seconds), 0.0)

    def _reset_extra_locked(self):
        self.productive_steps = 0
        self.wasted_steps = 0
        self.checkpoint_async_seconds = 0.0

    def snapshot(self) -> dict:
        """Point-in-time view: wall, per-phase seconds (idle = residual),
        goodput = compute/wall, and live MFU when FLOPs are registered."""
        wall, phases = self.wall_and_phases()
        with self._lock:
            productive = self.productive_steps
            wasted = self.wasted_steps
            ckpt_async = self.checkpoint_async_seconds
        goodput = phases["compute"] / wall if wall > 0 else 0.0
        mfu = None
        if (self.flops_per_step and self.peak_flops_total and wall > 0
                and productive):
            mfu = (self.flops_per_step * productive
                   / wall / self.peak_flops_total)
        return {
            "wall_seconds": wall,
            "phase_seconds": phases,
            "goodput": goodput,
            "mfu": mfu,
            "productive_steps": productive,
            "wasted_steps": wasted,
            # the checkpoint blocking/background split:
            # blocking is the ledger phase (it spends wall time on the
            # step thread), async is the overlapped writer-thread work
            "checkpoint_blocking_seconds": phases["checkpoint"],
            "checkpoint_async_seconds": ckpt_async,
        }


def _emit_chrome_span(lane: str, t_in: float, t_out: float):
    """Drop a `<lane_prefix>/<phase>` span onto the profiler sink so
    phase lanes interleave with RecordEvent spans and `throughput`
    instants in the chrome export. No-op (one predicate) unless the
    profiler is running; both clocks are CLOCK_MONOTONIC."""
    from ..profiler import emit_events, profiler_enabled
    if not profiler_enabled():
        return
    emit_events([{
        "name": lane, "ph": "X", "pid": 0,
        "tid": threading.get_ident() % 10000,
        "ts": t_in * 1e6, "dur": (t_out - t_in) * 1e6,
    }])


# ---- recompile sentinel ----
#
# ONE module-level listener is registered with the kernel loader while
# any sentinel is installed, and fans out to the installed sentinels.
_DISPATCH_LOCK = threading.Lock()
_ACTIVE_SENTINELS: set = set()
_BUILD_REGISTERED = False


def _build_dispatch(seconds):
    with _DISPATCH_LOCK:
        active = list(_ACTIVE_SENTINELS)
    for s in active:
        s.on_compile(seconds)


class RecompileSentinel:
    """Counts builds of the kernel library and alarms on post-warmup
    rebuilds.

    A build during warmup (before `mark_warm()`) is expected; one after
    it (the library's sources changed under a running process, or the
    build directory was emptied) drops a `train_recompile`
    flight-recorder event, and reaching `storm_threshold` of them logs a
    warning naming the count. Build seconds are booked to the ledger's
    `compile` phase so they are subtracted from productive compute.
    """

    def __init__(self, ledger: Optional[GoodputLedger] = None,
                 storm_threshold: int = 3):
        if storm_threshold < 1:
            raise ValueError(
                f"storm_threshold must be >= 1, got {storm_threshold}")
        self.ledger = ledger
        self.storm_threshold = int(storm_threshold)
        self.compiles = 0
        self.compile_seconds = 0.0
        self.recompiles = 0
        self.installed: Optional[str] = None  # "kernel_build"
        self._warm = False
        self._storm_warned = False
        self._lock = threading.Lock()

    def mark_warm(self):
        """Baseline: compilations so far were warmup, later ones are not."""
        with self._lock:
            self._warm = True

    def on_compile(self, seconds: float = 0.0):
        seconds = max(float(seconds), 0.0)
        with self._lock:
            self.compiles += 1
            self.compile_seconds += seconds
            is_recompile = self._warm
            if is_recompile:
                self.recompiles += 1
            count = self.recompiles
            storm = (is_recompile and count >= self.storm_threshold
                     and not self._storm_warned)
            if storm:
                self._storm_warned = True
        if self.ledger is not None:
            self.ledger.book("compile", seconds)
        if is_recompile:
            flight_recorder().record(
                "train_recompile", recompiles=count,
                seconds=round(seconds, 6), storm=storm)
            if storm:
                _log.warning(
                    "recompile storm: %d kernel-library builds after "
                    "warmup (threshold %d) — the library's sources or its "
                    "build directory are changing under the run",
                    count, self.storm_threshold)

    def install(self, source: str = "auto") -> "RecompileSentinel":
        """Start observing compilations. `source`: "kernel_build" (the
        kernel library's builds, the port's only compiles) or "auto"
        (the same). The JAX package's "monitoring" and "jit_cache"
        sources watch XLA, which the port does not run: they raise."""
        global _BUILD_REGISTERED
        if source not in ("auto",) + SOURCES:
            raise ValueError(
                f"unknown compile source {source!r}: the port compiles only "
                "its kernel library (source='kernel_build' or 'auto')")
        if self.installed is not None:
            return self
        from ..ops import _kernels
        with _DISPATCH_LOCK:
            register = not _BUILD_REGISTERED
            _BUILD_REGISTERED = True
            self.installed = "kernel_build"
            _ACTIVE_SENTINELS.add(self)
        if register:
            _kernels.add_build_listener(_build_dispatch)
        return self

    def uninstall(self):
        global _BUILD_REGISTERED
        with _DISPATCH_LOCK:
            self.installed = None
            _ACTIVE_SENTINELS.discard(self)
            drop = _BUILD_REGISTERED and not _ACTIVE_SENTINELS
            if drop:
                _BUILD_REGISTERED = False
        if drop:
            from ..ops import _kernels
            _kernels.remove_build_listener(_build_dispatch)

    def snapshot(self) -> dict:
        with self._lock:
            return {"compiles": self.compiles,
                    "recompiles": self.recompiles,
                    "compile_seconds": self.compile_seconds}


# ---- HBM telemetry ----

class HBMTelemetry:
    """The caching allocator's watermark gauges with static attribution.

    `sample()` reads the live allocator stats (unavailable without a
    card); `attribute()` records the byte sizes of the big static
    residents (params, optimizer state) so an OOM forensics dump can say
    what the device memory was holding. `stats_fn` is injectable for
    tests; the default reads `torch.cuda.memory_stats(device)` and maps
    it to the JAX key names: `bytes_in_use` is the allocated bytes now,
    `peak_bytes_in_use` their peak, `bytes_limit` the card's memory.
    """

    GAUGES = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

    def __init__(self, device=None, stats_fn: Optional[Callable] = None):
        if stats_fn is None:
            def stats_fn(_device=device):
                return _torch_memory_stats(_device)
        self._stats_fn = stats_fn
        self._lock = threading.Lock()
        self._attributed: Dict[str, int] = {}

    def attribute(self, component: str, nbytes: int):
        with self._lock:
            self._attributed[str(component)] = int(nbytes)

    @staticmethod
    def tree_nbytes(tree) -> int:
        """Total nbytes over a nested dict/list/tuple of arrays (torch
        tensors and numpy arrays)."""
        total = 0
        stack = [tree]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            else:
                n = getattr(x, "nbytes", None)
                if n is not None:
                    total += int(n)
        return total

    def sample(self) -> dict:
        try:
            stats = self._stats_fn()
        except Exception:
            stats = None
        out = {"available": bool(stats)}
        if stats:
            for k in self.GAUGES:
                if k in stats:
                    out[k] = int(stats[k])
        return out

    def snapshot(self) -> dict:
        s = self.sample()
        with self._lock:
            s["attributed"] = dict(self._attributed)
        return s


def _torch_memory_stats(device=None) -> Optional[dict]:
    """torch.cuda.memory_stats under the JAX key names, or None without a
    card."""
    import torch
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev)
            .total_memory}


def oom_forensics(exc: BaseException,
                  hbm: Optional[HBMTelemetry] = None) -> Optional[str]:
    """If `exc` is a `torch.cuda.OutOfMemoryError`, record a `train_oom`
    flight event carrying the memory watermarks + attribution and dump
    the black-box ring (reason="oom"). Returns the dump path, or None
    when the exception is not an OOM. Never raises."""
    import torch
    if not isinstance(exc, torch.cuda.OutOfMemoryError):
        return None
    try:
        msg = f"{type(exc).__name__}: {exc}"
    except Exception:
        msg = type(exc).__name__
    info = {"error": msg[:400]}
    if hbm is not None:
        snap = hbm.snapshot()
        for k in HBMTelemetry.GAUGES:
            if k in snap:
                info[f"hbm_{k}"] = snap[k]
        for comp, n in sorted(snap.get("attributed", {}).items()):
            info[f"attr_{comp}_bytes"] = n
    flight_recorder().record("train_oom", **info)
    return flight_recorder().try_dump(reason="oom")
