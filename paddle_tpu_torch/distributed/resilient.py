"""Resilient training runtime (counterpart of
paddle_tpu/distributed/resilient.py): step-level failure recovery over
the trainer/checkpoint stack.

The recovery contract covers more than the reference's auto_checkpoint
epoch-range resume (fluid/incubate/checkpoint/auto_checkpoint.py) +
elastic relaunch:

- **NaN/Inf loss sentinel** — a poisoned step is skipped (optimizer state
  untouched by the caller's convention below); too many consecutive skips
  escalate to a rollback onto the last valid checkpoint.
- **Hung-step watchdog** — a daemon thread interrupts the main thread when
  a step exceeds the deadline; the step is retried and escalates like any
  other transient failure. The interruption is a Python signal handler,
  which runs only when the main thread returns to the interpreter: it
  breaks a host-side hang (a sleep, a stuck queue), not a main thread
  blocked inside a CUDA synchronisation (the loss read), as JAX's
  `block_until_ready` is not broken either.
- **Bounded exponential-backoff retry** — transient host-side exceptions
  retry in place before escalating to rollback, then abort.
- **Preemption handling** — SIGTERM/SIGINT set a flag checked at every
  step boundary (after the loss read, so the device is idle); the
  runtime performs a final synchronous save, writes a resumable marker,
  and exits 143 so the scheduler sees a clean preemption.
- **Continuous checkpointing** — pass an `AsyncCheckpointManager` as
  `checkpoint` and save boundaries become host snapshots (blocking only
  for the device→host copy) persisted by a background writer;
  preemption/watchdog escalation emergency-saves the newest ring snapshot
  with no device round-trip, NaN rollback is served from the ring before
  touching disk, resume runs the corrupt-checkpoint scrubber first, and
  the `get_cursor`/`set_cursor` hooks carry data-stream state (iterator
  index, RNG) through the manifest so a resumed run replays the
  identical batch sequence.

Over a port train step, which updates its parameters and optimizer slots
in place, `set_state` must copy the restored tensors INTO the live ones
(`model.set_state_dict`, `optimizer.set_state_dict` do).

- **Numerics observatory** — `numerics=True` (or a
  `NumericsObservatory`) feeds every clean step's loss to the spike
  sentinel and reads the train fn's in-step telemetry
  (`numerics_host_sample`, on a step built armed) every
  `numerics_interval` steps; on a non-finite loss it runs the train fn's
  blame probe (`nonfinite_blame`) on the bad step's batch before the
  rollback destroys the evidence, booking the probe as `rollback_waste`,
  and the observatory emits the culprit-named `train_nonfinite` event.

`observatory=True` needs the compile observatory, which the port does not
have yet: it raises and names its ROADMAP item.

Fault paths are exercised deterministically via
paddle_tpu_torch.utils.fault_injection (PDTPU_FAULTS env spec).
"""
from __future__ import annotations

import math
import os
import json
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import torch

from ..checkpoint import AsyncCheckpointManager, CheckpointManager
from ..obs.flight_recorder import DUMP_DIR_ENV, flight_recorder
from ..obs.goodput import (GoodputLedger, HBMTelemetry, RecompileSentinel,
                           oom_forensics)
from ..obs.prom import MetricsServer, TrainingMetrics
from ..profiler import RecordEvent, record_instant
from ..utils import fault_injection
from .trainer import DeviceWorker, _host_losses

PREEMPT_MARKER = "preempted.json"


class UnrecoverableError(RuntimeError):
    """Raised when the retry → rollback escalation budget is exhausted."""


class WatchdogTimeout(RuntimeError):
    """Internal: a step exceeded the watchdog deadline."""


class ResilientConfig:
    """Escalation policy knobs (defaults tuned for tests/small runs)."""

    def __init__(self, nan_policy: str = "skip",
                 max_consecutive_skips: int = 3,
                 max_rollbacks: int = 2,
                 max_step_retries: int = 2,
                 retry_backoff: float = 0.25,
                 watchdog_timeout: Optional[float] = None,
                 save_interval: int = 1):
        if nan_policy not in ("skip", "rollback", "abort"):
            raise ValueError(f"unknown nan_policy {nan_policy!r}")
        if watchdog_timeout is None:
            # fall back to the framework flag (0.0 = disabled)
            from ..flags import get_flags
            watchdog_timeout = get_flags("FLAGS_step_watchdog_timeout")[
                "FLAGS_step_watchdog_timeout"] or None
        self.nan_policy = nan_policy
        self.max_consecutive_skips = max_consecutive_skips
        self.max_rollbacks = max_rollbacks
        self.max_step_retries = max_step_retries
        self.retry_backoff = retry_backoff
        self.watchdog_timeout = watchdog_timeout
        self.save_interval = save_interval


class _Watchdog:
    """Daemon thread that interrupts the main thread when the in-flight
    step exceeds `timeout` seconds (no beat). `fire` delivers the
    interruption — the runtime wires it to pthread_kill(main, SIGUSR1)
    whose handler raises WatchdogTimeout, which also breaks out of a
    time.sleep-style hang. (interrupt_main is NOT used: it simulates
    SIGINT, which the preemption handler owns.)"""

    def __init__(self, timeout: float, fire: Callable[[], None]):
        self.timeout = timeout
        self._fire = fire
        self.fired = False
        self._beat = time.monotonic()
        self._in_step = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def step_begin(self):
        self.fired = False
        self._beat = time.monotonic()
        self._in_step = True

    def step_end(self):
        self._in_step = False

    def _loop(self):
        poll = max(self.timeout / 4.0, 0.01)
        while not self._stop.wait(poll):
            if (self._in_step and not self.fired
                    and time.monotonic() - self._beat > self.timeout):
                self.fired = True
                self._in_step = False
                self._fire()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def _loss_value(loss) -> Optional[float]:
    """Scalar view of a step's loss, or None if it has no scalar form."""
    try:
        if torch.is_tensor(loss) or hasattr(loss, "item"):
            return float(loss.item())
        if isinstance(loss, (int, float)):
            return float(loss)
        if isinstance(loss, (tuple, list)) and loss:
            return _loss_value(loss[0])
    except (TypeError, ValueError, RuntimeError):
        pass
    return None


# what `observatory=` needs, and the item that ports it
_REFUSED = ("the compile observatory (obs/compile_observatory.py) waits "
            "for ROADMAP §1 item 9")


class ResilientTrainer:
    """Wraps a DeviceWorker-style train fn with step-level recovery.

    usage:
        trainer = ResilientTrainer(
            train_fn, ckpt_dir,
            get_state=lambda: {"model": model.state_dict(), ...},
            set_state=lambda s: model.set_state_dict(s["model"]),
            config=ResilientConfig(watchdog_timeout=30))
        summary = trainer.run(batch_fn, num_steps=1000)

    `batch_fn` maps a 0-based step index to the step's batch (so the same
    data is replayed after rollback); a sequence works too. `get_state`
    must capture everything needed to resume (params, optimizer, RNG).
    Checkpoints are indexed by *completed step count*: step k's checkpoint
    is saved under k+1, so `latest_step()` is also the resume index.

    Scan-fused steps (parallel.ScanTrainStep) are driven at CHUNK
    granularity: each call covers K steps and returns the per-step loss
    vector, so the NaN/Inf sentinel still localizes the exact bad step.
    `batch_fn` then receives the chunk's START step and must return the
    stacked [K, ...] chunk (a sequence is indexed by `step // K`); a bad
    loss anywhere in a chunk always escalates to rollback, because the
    fused later steps already consumed the poisoned params — skip is
    impossible mid-chunk. Checkpoints land at the first chunk boundary at
    or past each save_interval multiple.

    `device`: where a CheckpointManager built from a directory path puts
    restored tensors (default: the train fn's `device`, else the first
    GPU); a manager passed in keeps its own.
    """

    def __init__(self, train_fn: Callable, checkpoint: Any,
                 get_state: Callable[[], Dict[str, Any]],
                 set_state: Callable[[Dict[str, Any]], None],
                 config: Optional[ResilientConfig] = None,
                 fault_plan: Optional[fault_injection.FaultPlan] = None,
                 callbacks: Optional[List] = None,
                 use_orbax: bool = True,
                 metrics_port: Optional[int] = None,
                 goodput: bool = False,
                 observatory: bool = False,
                 numerics: bool = False,
                 numerics_interval: int = 10,
                 get_cursor: Optional[Callable[[], Dict[str, Any]]] = None,
                 set_cursor: Optional[
                     Callable[[Dict[str, Any]], None]] = None,
                 device=None):
        if observatory:
            raise NotImplementedError(f"observatory=True: {_REFUSED}")
        self.worker = DeviceWorker(train_fn, print_period=0)
        if isinstance(checkpoint, (AsyncCheckpointManager,
                                   CheckpointManager)):
            self.ckpt = checkpoint
        else:
            if device is None:
                device = getattr(train_fn, "device", None)
            self.ckpt = CheckpointManager(checkpoint, use_orbax=use_orbax,
                                          device=device)
        # continuous tier: save boundaries snapshot instead of
        # blocking on a full save, save_interval IS the snapshot interval
        self._async_ckpt = isinstance(self.ckpt, AsyncCheckpointManager)
        self.get_state = get_state
        self.set_state = set_state
        # exact-resume cursor hooks: get_cursor captures JSON-safe data-
        # stream state (iterator index, RNG — see checkpoint.rng_cursor)
        # at each save boundary; set_cursor rewinds the stream on resume
        # AND after a rollback, so replayed steps consume the same batches
        self.get_cursor = get_cursor
        self.set_cursor = set_cursor
        self.config = config or ResilientConfig()
        self.plan = fault_plan if fault_plan is not None \
            else fault_injection.global_plan()
        self.callbacks = callbacks or []
        self.events: List[Dict[str, Any]] = []
        self._preempt_signal: Optional[int] = None
        # goodput=True arms the wall-clock ledger + recompile sentinel +
        # memory gauges. Disabled (the default) every hook below and in
        # DeviceWorker/ScanTrainStep/ChunkPrefetcher stays at exactly one
        # `is not None` predicate.
        self.ledger: Optional[GoodputLedger] = None
        self.sentinel: Optional[RecompileSentinel] = None
        self.hbm: Optional[HBMTelemetry] = None
        if goodput:
            self.ledger = GoodputLedger()
            self.sentinel = RecompileSentinel(self.ledger).install()
            self.hbm = HBMTelemetry(device=getattr(train_fn, "device",
                                                   None))
            self.worker.ledger = self.ledger
            if hasattr(train_fn, "ledger"):  # ScanTrainStep h2d staging
                train_fn.ledger = self.ledger
            if self._async_ckpt:
                # writer-thread persist seconds feed the non-phase
                # checkpoint_async counter (blocking stays the phase)
                self.ckpt.ledger = self.ledger
        # numerics=True arms the training numerics observatory: the
        # loss-spike sentinel, sampled in-step telemetry and the
        # culprit-named blame probe on bad_loss. Off = the same
        # one-predicate contract as goodput. Pass a NumericsObservatory to
        # share or configure one; the telemetry also needs the step BUILT
        # armed (strategy.numerics or ShardedTrainStep(numerics=True)),
        # the blame probe and the spike sentinel work either way.
        self.numerics = None
        if numerics:
            from ..obs.numerics import NumericsObservatory
            self.numerics = (numerics if isinstance(
                numerics, NumericsObservatory)
                else NumericsObservatory(interval=numerics_interval))
            from ..flags import get_flags
            if get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]:
                import warnings
                warnings.warn(
                    "FLAGS_check_nan_inf (torch anomaly detection) and the "
                    "numerics observatory are both armed: anomaly "
                    "detection RAISES at the first backward op that makes "
                    "a non-finite value, so the step never returns a loss "
                    "and the observatory's culprit-named blame probe (and "
                    "rollback) never runs. Prefer numerics=True alone in "
                    "production; keep FLAGS_check_nan_inf for op-level "
                    "debugging", stacklevel=2)
        # pdtpu_train_* exporter: throughput gauges read the worker's
        # tracker, counters are fed from _event / the checkpoint sites
        self.metrics = TrainingMetrics(tracker=self.worker.throughput,
                                       ledger=self.ledger, hbm=self.hbm,
                                       sentinel=self.sentinel,
                                       numerics=self.numerics,
                                       ckpt=(self.ckpt if self._async_ckpt
                                             else None))
        env_port = os.environ.get("PDTPU_METRICS_PORT")
        if metrics_port is None and env_port:
            metrics_port = int(env_port)
        self.metrics_server: Optional[MetricsServer] = None
        if metrics_port is not None:
            self.metrics_server = MetricsServer(
                [self.metrics.render], port=metrics_port).start()

    # ---- event plumbing ----
    def _event(self, kind: str, step: int, **info):
        rec = {"kind": kind, "step": step, **info}
        self.events.append(rec)
        record_instant(f"resilient/{kind}", args=rec)
        self.metrics.on_event(kind, step)
        # JSON-safe subset only: info may carry exception objects
        flight_recorder().record(
            f"train_{kind}", step=step,
            **{k: v for k, v in info.items()
               if isinstance(v, (str, int, float, bool, type(None)))})
        for cb in self.callbacks:
            on_fault = getattr(cb, "on_fault", None)
            if on_fault is not None:
                on_fault(kind, step, dict(info))
        print(f"[resilient] {kind} at step {step} {info}", file=sys.stderr)

    def _on_checkpoint_save(self, step: int):
        """Counter + black-box record for a checkpoint save. Deliberately
        NOT routed through _event: self.events is a stable recovery-protocol
        record (tests and callbacks consume exact sequences) and periodic
        saves are not fault events."""
        self.metrics.on_event("checkpoint_save", step)
        flight_recorder().record("train_checkpoint_save", step=step)

    def _cursor(self) -> Optional[Dict[str, Any]]:
        return self.get_cursor() if self.get_cursor is not None else None

    def _save_boundary(self, step: int):
        """One save boundary: a ring snapshot (async tier — blocks only
        for the host fetch, the writer persists in the background) or the
        classic synchronous save. Either way the cursor rides along."""
        if self._async_ckpt:
            self.ckpt.snapshot(step, self.get_state(),
                               cursor=self._cursor())
        else:
            self.ckpt.save(step, self.get_state(), cursor=self._cursor())

    def _apply_cursor(self, cursor: Optional[Dict[str, Any]]):
        if self.set_cursor is not None and cursor is not None:
            self.set_cursor(cursor)

    # ---- numerics observatory hooks (obs/numerics.py) ----
    def _numerics_tick(self, step: int, n: int, losses):
        """Clean-step feed: per-step losses into the spike sentinel, and
        on the numerics interval a host read of the in-step telemetry.
        Callers guard with `self.numerics is not None`."""
        for i, v in enumerate(losses):
            self.numerics.observe_loss(step + i, float(v))
        if not self.numerics.should_sample(step + n, n):
            return
        fn = getattr(self.worker.train_fn, "numerics_host_sample", None)
        sample = fn() if fn is not None else None
        if sample:
            self.numerics.observe_sample(step + n, sample)

    def _numerics_blame(self, bad_step: int, batch, idx: Optional[int]):
        """Culprit-named non-finite blame: the bad step's batch through the
        train fn's blame probe (a grad and param leaf census, no update),
        then the `train_nonfinite` flight event and dump, BEFORE the
        rollback destroys the evidence. The probe's wall time is booked as
        rollback_waste. `idx` selects the bad step's row of a stacked
        chunk batch."""
        probe = getattr(self.worker.train_fn, "nonfinite_blame", None)
        if probe is None:
            return  # a plain train fn has no loss closure to probe
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        if idx is not None:
            args = tuple(a[idx] for a in args)
        try:
            if self.ledger is not None:
                with self.ledger.measure("rollback_waste"):
                    report = probe(bad_step + 1, *args)
            else:
                report = probe(bad_step + 1, *args)
        except Exception as e:  # never let forensics mask the recovery
            print(f"[resilient] non-finite blame probe failed at step "
                  f"{bad_step}: {type(e).__name__}: {e}", file=sys.stderr)
            return
        self.numerics.observe_nonfinite(bad_step, report)

    # ---- preemption ----
    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempt_signal = signum
        self._old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old_handlers[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass

    def _restore_signal_handlers(self):
        for sig, old in getattr(self, "_old_handlers", {}).items():
            signal.signal(sig, old)

    def _final_save(self, completed: int):
        """The preemption save. Async tier: take one last boundary
        snapshot (we are AT a step boundary, so the host fetch is safe),
        emergency-persist the newest ring entry — the signal path proper,
        no further device round-trips — and drain the writer so nothing
        queued is lost. Sync tier: the classic forced save."""
        if self._async_ckpt:
            self.ckpt.snapshot(completed, self.get_state(),
                               cursor=self._cursor())
            self.ckpt.emergency_save()
            self.ckpt.wait_until_finished()
        else:
            self.ckpt.save(completed, self.get_state(), force=True,
                           cursor=self._cursor())
            self.ckpt.wait_until_finished()

    def _preempt_exit(self, completed: int):
        """Final synchronous save + resumable marker, then exit 143."""
        with RecordEvent("resilient/preempt_save"):
            if self.ledger is not None:
                with self.ledger.measure("checkpoint"):
                    self._final_save(completed)
            else:
                self._final_save(completed)
        self._on_checkpoint_save(completed)
        marker = os.path.join(self.ckpt.directory, PREEMPT_MARKER)
        with open(marker, "w") as f:
            json.dump({"step": completed, "resumable": True,
                       "signal": self._preempt_signal,
                       "time": time.time()}, f)
        self._event("preempted", completed, signal=self._preempt_signal)
        # black-box dump next to the checkpoint (unless PDTPU_FLIGHT_DIR
        # points elsewhere): the exiting process leaves its postmortem
        # where the resuming one will look first
        path = None
        if not os.environ.get(DUMP_DIR_ENV):
            path = os.path.join(self.ckpt.directory,
                                f"pdtpu_flight_{os.getpid()}.json")
        flight_recorder().try_dump(path=path, reason="preempt")
        raise SystemExit(143)

    # ---- recovery actions ----
    def _restore_latest(self):
        """Restore the newest recoverable state; returns (step, source).
        Async tier: the in-memory ring first — it holds the freshest
        snapshot (possibly newer than anything certified on disk) and
        costs no I/O — then disk. The cursor rides along either way, so
        the data stream rewinds with the params."""
        if self._async_ckpt:
            snap = self.ckpt.newest_snapshot()
            if snap is not None:
                self.set_state(self.ckpt.ring_state(snap))
                self._apply_cursor(snap.cursor)
                return snap.step, "ring"
        latest = self.ckpt.latest_step()
        restored = self.ckpt.restore(latest) if latest is not None else None
        if restored is not None:
            self.set_state(restored)
            self._apply_cursor(self.ckpt.read_cursor(latest))
        return latest, "disk"

    def _rollback(self, state: Dict[str, int]) -> int:
        state["rollbacks"] += 1
        if state["rollbacks"] > self.config.max_rollbacks:
            raise UnrecoverableError(
                f"rollback budget exhausted ({self.config.max_rollbacks}); "
                "aborting")
        if self.ledger is not None:
            with self.ledger.measure("checkpoint"):
                latest, source = self._restore_latest()
        else:
            latest, source = self._restore_latest()
        target = latest if latest is not None else 0
        self._event("rollback", target, rollbacks=state["rollbacks"],
                    source=source)
        state["skips"] = 0
        return target

    def run(self, batches, num_steps: Optional[int] = None) -> Dict[str, Any]:
        """Drive `num_steps` steps with recovery; returns a summary dict."""
        n = max(1, int(self.worker.scan_steps))
        batch_fn = batches if callable(batches) else \
            (lambda i, _b=batches: _b[i // n])
        if num_steps is None:
            if callable(batches):
                raise ValueError("num_steps is required with a batch_fn")
            num_steps = len(batches) * n
        if num_steps % n:
            raise ValueError(
                f"num_steps={num_steps} must be a multiple of the fused "
                f"chunk size scan_steps={n} (a chunk is K steps; trim or "
                "pad the run)")

        self._install_signal_handlers()
        watchdog = None
        old_usr1 = None
        if self.config.watchdog_timeout:
            def _usr1_handler(signum, frame):
                raise WatchdogTimeout(
                    f"step exceeded {self.config.watchdog_timeout}s")

            main_id = threading.main_thread().ident

            def _fire():
                signal.pthread_kill(main_id, signal.SIGUSR1)

            try:
                old_usr1 = signal.signal(signal.SIGUSR1, _usr1_handler)
            except ValueError:  # not the main thread: no watchdog delivery
                pass
            else:
                watchdog = _Watchdog(self.config.watchdog_timeout, _fire)
                watchdog.start()

        if self.ledger is not None:
            self.ledger.start()  # wall clock covers the whole run() call
            self.sentinel.install()  # no-op when already observing

        # scrub BEFORE trusting latest_step: a manifest-certified step
        # whose bytes rotted (torn block, ckpt_torn_write) must be
        # quarantined, not restored — the scrubber walks the directory,
        # CRC-checks every candidate and moves failures to *.corrupt/
        if self._async_ckpt:
            report = self.ckpt.scrub()
            for rec in report["quarantined"]:
                self._event("ckpt_quarantined", rec["step"],
                            file=rec["file"], reason=rec["reason"])

        # resume from the latest valid checkpoint
        completed = self.ckpt.latest_step() or 0
        if completed % n:
            raise ValueError(
                f"checkpoint at step {completed} does not sit on a "
                f"scan_steps={n} chunk boundary (was it written by an "
                "eager run?); resume with the same chunking it was "
                "saved under")
        if completed:
            if self.ledger is not None:
                with self.ledger.measure("checkpoint"):
                    restored = self.ckpt.restore(completed)
            else:
                restored = self.ckpt.restore(completed)
            if restored is not None:
                self.set_state(restored)
                # rewind the data stream to the checkpoint's cursor so
                # the resumed run replays the identical batch sequence
                self._apply_cursor(self.ckpt.read_cursor(completed))
            self._event("resumed", completed)
        marker = os.path.join(self.ckpt.directory, PREEMPT_MARKER)
        if os.path.exists(marker):
            os.remove(marker)

        esc = {"skips": 0, "rollbacks": 0}
        retries_total = 0
        last_loss = None
        # highest step index ever completed this run: re-running a chunk
        # below the watermark after a rollback is rollback_waste, not
        # productive compute
        watermark = completed
        try:
            step = completed
            while step < num_steps:
                if self._preempt_signal is not None:
                    self._preempt_exit(step)
                attempts = 0
                while True:  # retry loop for one step (or fused chunk)
                    try:
                        # host-side faults scheduled mid-chunk fire at the
                        # chunk boundary — the host can't intervene inside
                        # a fused dispatch
                        for s in range(step, step + n):
                            self.plan.maybe_kill(
                                s, fault_injection.KILL_POINT_STEP)
                            self.plan.maybe_raise(s)
                        if watchdog is not None:
                            watchdog.step_begin()
                        with RecordEvent("resilient/step"):
                            for s in range(step, step + n):
                                self.plan.maybe_delay(s)
                            if self.ledger is not None:
                                # batch production (incl. a prefetcher's
                                # blocking get) is data_wait; device time
                                # below the watermark is rollback waste
                                with self.ledger.measure("data_wait"):
                                    batch = batch_fn(step)
                                self.worker.ledger_phase = (
                                    "rollback_waste"
                                    if step + n <= watermark else "compute")
                            else:
                                batch = batch_fn(step)
                            # nan_input/inf_input faults poison the batch
                            # itself: non-finite device gradients
                            batch = self.plan.corrupt_batch(step, batch, n)
                            loss = self.worker.run_step(batch)
                        if watchdog is not None:
                            watchdog.step_end()
                        loss = self.plan.corrupt_loss_vector(step, loss) \
                            if n > 1 else self.plan.corrupt_loss(step, loss)
                        break
                    except WatchdogTimeout:
                        self._event("watchdog_timeout", step)
                        if self._async_ckpt:
                            # the device may be wedged: persist the newest
                            # ring snapshot NOW, without touching it —
                            # if escalation ends in abort, the operator
                            # still has the freshest state on disk
                            self.ckpt.emergency_save()
                        loss = None
                    except (KeyboardInterrupt, SystemExit,
                            UnrecoverableError):
                        raise
                    except Exception as e:
                        if self.hbm is not None:  # CUDA OOM dump
                            oom_forensics(e, self.hbm)
                        self._event("step_error", step,
                                    error=f"{type(e).__name__}: {e}")
                    # transient failure: bounded backoff retry, then rollback
                    attempts += 1
                    if attempts <= self.config.max_step_retries:
                        retries_total += 1
                        self._event("retry", step, attempt=attempts)
                        backoff = (self.config.retry_backoff
                                   * (2 ** (attempts - 1)))
                        if self.ledger is not None:
                            with self.ledger.measure("rollback_waste"):
                                time.sleep(backoff)
                        else:
                            time.sleep(backoff)
                        continue
                    step = self._rollback(esc)
                    attempts = 0

                # NaN/Inf sentinel
                if n > 1:
                    # per-step loss vector: localize the first bad step
                    vec = _host_losses(loss).astype(np.float64)
                    bad = np.flatnonzero(~np.isfinite(vec))
                    if bad.size:
                        bad_step = step + int(bad[0])
                        self._event("bad_loss", bad_step,
                                    value=str(float(vec[bad[0]])),
                                    chunk_start=step)
                        if self.numerics is not None:
                            # blame BEFORE abort/rollback destroys the
                            # evidence (params are about to be restored)
                            self._numerics_blame(bad_step, batch,
                                                 idx=int(bad[0]))
                        if self.config.nan_policy == "abort":
                            raise UnrecoverableError(
                                f"non-finite loss {float(vec[bad[0]])} at "
                                f"step {bad_step} (nan_policy=abort)")
                        # the fused steps after bad_step already consumed
                        # the poisoned params — skip is impossible
                        # mid-chunk, always roll back
                        step = self._rollback(esc)
                        continue
                else:
                    val = _loss_value(loss)
                    if val is not None and not math.isfinite(val):
                        self._event("bad_loss", step, value=str(val))
                        if self.numerics is not None:
                            self._numerics_blame(step, batch, idx=None)
                        if self.config.nan_policy == "abort":
                            raise UnrecoverableError(
                                f"non-finite loss {val} at step {step} "
                                "(nan_policy=abort)")
                        esc["skips"] += 1
                        if (self.config.nan_policy == "rollback"
                                or esc["skips"]
                                > self.config.max_consecutive_skips):
                            step = self._rollback(esc)
                        else:
                            self._event("skip", step,
                                        consecutive=esc["skips"])
                            step += 1  # skip the batch, don't checkpoint it
                        continue
                if self.numerics is not None:
                    # clean step(s): feed the spike sentinel and (on the
                    # numerics_interval) sample the in-step telemetry
                    self._numerics_tick(
                        step, n, [float(v) for v in vec] if n > 1
                        else ([] if val is None else [val]))
                esc["skips"] = 0
                last_loss = loss
                step += n
                watermark = max(watermark, step)
                if self.sentinel is not None:
                    # first clean step ends warmup: later builds are
                    # recompiles (idempotent flag set)
                    self.sentinel.mark_warm()
                si = self.config.save_interval
                # first boundary at/past each save_interval multiple (for
                # n == 1 this is exactly `step % si == 0`)
                self.metrics.set_step(step)
                if (step // si) > ((step - n) // si) or step == num_steps:
                    with RecordEvent("resilient/save"):
                        if self.ledger is not None:
                            # the measured span is the BLOCKING cost only:
                            # async persists happen on the writer thread
                            # and book checkpoint_async_seconds instead
                            with self.ledger.measure("checkpoint"):
                                self._save_boundary(step)
                        else:
                            self._save_boundary(step)
                    self._on_checkpoint_save(step)
            if self._preempt_signal is not None:
                self._preempt_exit(step)
            self.ckpt.wait_until_finished()
            summary = {"completed_steps": step, "last_loss": last_loss,
                       "retries": retries_total,
                       "rollbacks": esc["rollbacks"],
                       "preempted": False, "events": list(self.events)}
            if self.ledger is not None:
                summary["goodput"] = self.ledger.snapshot()
            if self._async_ckpt:
                summary["checkpoint"] = self.ckpt.stats()
            return summary
        finally:
            if self.sentinel is not None:
                # detach from the process-global build dispatcher so a
                # finished trainer doesn't keep counting other runs'
                # builds; run() re-installs on re-entry (resume)
                self.sentinel.uninstall()
            if watchdog is not None:
                watchdog.stop()
            if old_usr1 is not None:
                signal.signal(signal.SIGUSR1, old_usr1)
            self._restore_signal_handlers()
