"""Deterministic fault-injection harness for the resilient runtime
(counterpart of paddle_tpu/utils/fault_injection.py: the same grammar,
the same firing rules, the same `FaultPlan`).

Faults are declared as a spec string — via the ``PDTPU_FAULTS`` env var or
``FLAGS_fault_injection_spec`` — and fire at exact step indices, so every
recovery path in paddle_tpu_torch.distributed.resilient can be exercised
end-to-end by tests without flaky timing games.

Spec grammar (';'-separated clauses, each ``kind@step[:arg]``):

    nan_loss@3            inject a NaN loss at step 3
    inf_loss@3            inject an Inf loss at step 3
    nan_input@3:1         poison batch element 1 with NaN at step 3 (the
                          poison flows through the device forward/backward,
                          so the numerics observatory's non-finite blame
                          probe sees genuinely bad grad leaves — unlike
                          nan_loss, which corrupts only the host-side loss)
    inf_input@3           poison batch element 0 with Inf at step 3
    raise@5               raise RuntimeError at step 5 (transient-failure path)
    raise@5:OSError       raise a named builtin exception instead
    delay@7:2.5           sleep 2.5s inside step 7 (trips the watchdog)
    kill@4:mid_save       SIGKILL self at step 4 when the 'mid_save' kill
                          point is reached (torn-write path); the point name
                          matches CheckpointManager's kill points
    kill@4:step           SIGKILL self at the top of step 4
    kill@4:persist        SIGKILL while the AsyncCheckpointManager writer
                          thread persists snapshot 4 (kill-during-
                          background-persist: the previous certified step
                          must restore)
    ckpt_io_stall@4:2.0   the background writer stalls 2.0s before
                          persisting snapshot 4 — the writer falls behind,
                          so the snapshot ring's drop-oldest backpressure
                          (`ckpt_lag`) becomes observable
    ckpt_torn_write@4     truncate checkpoint 4's data file AFTER its
                          manifest landed: a manifest-certified-but-corrupt
                          step (bit rot / torn block) that only the restore
                          scrubber can catch

Serving-side clauses key on the engine's *dispatch index* (the
running count of jitted prefill/decode attempts) or on a request's
*submit index*, so the supervision protocol in ``serving/supervisor.py``
and the engines' retry/quarantine paths are provable at exact points:

    dispatch_raise@5      raise inside the 5th dispatch (transient failure:
                          fires once, so the engine's retry succeeds)
    dispatch_hang@5:3.0   the 5th dispatch "hangs" for 3.0s — raised as
                          InjectedDispatchHang, which EngineSupervisor maps
                          onto its hung-dispatch watchdog path without
                          burning real wall time under a SimClock
    poison_request@2      every dispatch carrying submit-index-2's rows
                          raises — PERSISTENTLY, across retries (that is
                          what makes a request poisoned rather than the
                          fault transient); the engine must quarantine it
    poison_request@2:decode   only decode dispatches are poisoned (the
                          request survives prefill, exercising the decode
                          blame-isolation protocol)

Replica-tier clauses key on the REPLICA INDEX instead of a
step counter — the router polls ``maybe_replica_fault(i)`` at the top of
every replica pump, so replica death is placeable without real signals:

    replica_crash@1       replica 1 hard-crashes at its next pump (fires
                          once): every in-flight stream on it must be
                          failed over to a survivor, not dropped
    replica_hang@1:30.0   replica 1 stops making forward progress for
                          30.0 simulated seconds — the router's
                          hung-forward watchdog must fire
    replica_slow@1:50     replica 1 adds 50ms latency to EVERY pump —
                          persistent (logs once), the load-aware tier of
                          the routing policy must steer around it

Rolling-deploy clauses exercise the drain→swap→canary→
re-admit pipeline in ``serving/deploy.py``; ``swap_stall`` keys on the
replica index, ``deploy_bad_weights`` on the controller's lifetime
deploy counter (0 = the first deploy this process runs):

    swap_stall@1:2.5      replica 1's in-place weight swap takes 2.5
                          extra (simulated) seconds to settle — the
                          canary gate must wait for the swap instead of
                          probing half-installed weights
    deploy_bad_weights@0  the first deploy loads weights that fail the
                          canary (NaN-poisoned after the certified
                          load, so certification still passes): the
                          controller must roll the whole fleet back

Each clause fires exactly once per process (a restarted process re-arms,
which is what crash-resume tests want) — except ``poison_request`` and
``replica_slow``, whose defining property is persistence: they log once
but keep firing.
``FaultPlan`` is also usable programmatically for in-process tests.

Differences from the JAX package, none in what fires when:
- the loss and batch poisons write NaN/Inf into torch tensors on their
  own device (`torch.full_like`, an indexed fill), so a poisoned step
  waits for the host no more than a clean one; numpy values and Python
  floats are poisoned as in JAX;
- a ``kill`` clause sends the process SIGKILL (a parent's `Popen` sees
  returncode -9, a shell 137) where the JAX package calls
  `os._exit(137)`: either way no atexit handler or `finally` runs;
- the serving clauses ``dispatch_*`` and ``poison_request`` are called
  by `serving.llm.LLMEngine` and `serving.BatchingEngine` through
  `maybe_dispatch_fault`; ``replica_*`` and ``swap_stall`` by
  `serving.router.InProcessReplica`, ``deploy_bad_weights`` by
  `serving.deploy.DeploymentController`, as in JAX; the poisoned weights
  are NaN tensors of the loaded ones' shapes, dtypes and devices.
"""
from __future__ import annotations

import builtins
import os
import signal
import time
from typing import Dict, List, Optional

ENV_VAR = "PDTPU_FAULTS"

# kill points recognised by CheckpointManager.save (fallback path)
KILL_POINT_MID_SAVE = "mid_save"        # after data write, before any rename
KILL_POINT_AFTER_DATA = "after_data"    # after data rename, before manifest
KILL_POINT_STEP = "step"                # top of the training step
KILL_POINT_PERSIST = "persist"          # AsyncCheckpointManager writer, at
#                                         the top of a background persist


class InjectedDispatchHang(RuntimeError):
    """A dispatch_hang clause fired: the dispatch would have blocked for
    `seconds`. EngineSupervisor converts this to its DispatchHungError
    watchdog path so SimClock tests prove the hang protocol with zero real
    sleeps; it is never meant to escape the supervisor."""

    def __init__(self, seconds: float):
        super().__init__(f"injected dispatch hang ({seconds:.1f}s)")
        self.seconds = float(seconds)


class Fault:
    __slots__ = ("kind", "step", "arg", "fired")

    def __init__(self, kind: str, step: int, arg: Optional[str] = None):
        self.kind = kind
        self.step = step
        self.arg = arg
        self.fired = False

    def __repr__(self):
        a = f":{self.arg}" if self.arg else ""
        return f"{self.kind}@{self.step}{a}"


def _parse(spec: str) -> List[Fault]:
    faults = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        head, _, arg = clause.partition(":")
        kind, _, step = head.partition("@")
        if not step:
            raise ValueError(
                f"fault clause {clause!r} missing '@step' (grammar: "
                "kind@step[:arg])")
        faults.append(Fault(kind.strip(), int(step), arg.strip() or None))
    return faults


class FaultPlan:
    """A deterministic schedule of faults keyed by (kind, step)."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = faults or []
        self.log: List[str] = []   # what actually fired, for assertions

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        return cls(_parse(spec))

    @classmethod
    def from_env(cls) -> "FaultPlan":
        """Build from PDTPU_FAULTS, falling back to the framework flag."""
        spec = os.environ.get(ENV_VAR, "")
        if not spec:
            try:
                from ..flags import get_flags
                spec = get_flags("FLAGS_fault_injection_spec")[
                    "FLAGS_fault_injection_spec"]
            except Exception:
                spec = ""
        return cls.from_spec(spec) if spec else cls()

    def add(self, kind: str, step: int, arg: Optional[str] = None):
        self.faults.append(Fault(kind, step, arg))
        return self

    def _take(self, kind: str, step: int,
              arg: Optional[str] = None) -> Optional[Fault]:
        for f in self.faults:
            if f.fired or f.kind != kind or f.step != step:
                continue
            if arg is not None and f.arg != arg:
                continue
            f.fired = True
            self.log.append(repr(f))
            return f
        return None

    # ---- injection points ----
    def corrupt_loss(self, step: int, loss):
        """Return a NaN/Inf-poisoned loss if one is scheduled for `step`:
        a tensor of the loss's shape, dtype and device (no host sync), or
        a float for anything else."""
        f = self._take("nan_loss", step) or self._take("inf_loss", step)
        if f is None:
            return loss
        val = float("nan") if f.kind == "nan_loss" else float("inf")
        import torch
        if torch.is_tensor(loss):
            return torch.full_like(loss.detach(), val)
        return val

    def corrupt_loss_vector(self, step0: int, losses):
        """Chunked analog of `corrupt_loss`: `losses` is the per-step loss
        vector of a scan-fused chunk covering global steps
        [step0, step0 + K). A nan_loss/inf_loss clause scheduled inside
        that range poisons its element, so mid-chunk sentinel paths are
        testable without touching device state. A tensor is poisoned in a
        copy on its own device; numpy and sequences as in JAX."""
        import numpy as np
        import torch
        is_t = torch.is_tensor(losses)
        vec = losses.detach().reshape(-1) if is_t \
            else np.atleast_1d(np.asarray(losses))
        k = vec.shape[0]
        poisoned = None
        for kind, val in (("nan_loss", float("nan")),
                          ("inf_loss", float("inf"))):
            for f in self.faults:
                if f.fired or f.kind != kind or \
                        not (step0 <= f.step < step0 + k):
                    continue
                f.fired = True
                self.log.append(repr(f))
                if poisoned is None:
                    if is_t:
                        poisoned = vec.clone() if vec.is_floating_point() \
                            else vec.float()
                    else:
                        poisoned = np.array(
                            vec, dtype=vec.dtype if vec.dtype.kind == "f"
                            else np.float32)
                poisoned[f.step - step0] = val
        if poisoned is None:
            return losses
        return poisoned

    def corrupt_batch(self, step0: int, batch, k: int = 1):
        """Poison one batch array with NaN/Inf if a nan_input/inf_input
        clause is scheduled in [step0, step0 + k): the real-data analog
        of corrupt_loss — the poison flows through the device
        forward/backward. ``arg`` selects the batch element index
        (default 0); integer arrays are promoted to float32 so the poison
        is representable. For a stacked [K, ...] chunk (k > 1) only the
        scheduled step's row is poisoned. A tensor is poisoned in a copy
        on its own device."""
        hits = [f for f in self.faults
                if not f.fired and f.kind in ("nan_input", "inf_input")
                and step0 <= f.step < step0 + k]
        if not hits:
            return batch
        import numpy as np
        import torch
        seq = isinstance(batch, (tuple, list))
        items = list(batch) if seq else [batch]
        for f in hits:
            f.fired = True
            self.log.append(repr(f))
            idx = int(f.arg or 0)
            if not (0 <= idx < len(items)):
                continue
            a = items[idx]
            if torch.is_tensor(a):
                arr = a.detach().clone() if a.is_floating_point() \
                    else a.detach().float()
            else:
                arr = np.asarray(a)
                arr = (arr.astype(np.float32) if arr.dtype.kind != "f"
                       else arr.copy())
            val = float("nan") if f.kind == "nan_input" else float("inf")
            if k > 1:
                arr[f.step - step0] = val
            else:
                arr[...] = val
            items[idx] = arr
        return (type(batch)(items) if seq else items[0])

    def maybe_raise(self, step: int):
        """Raise a transient-failure exception if scheduled for `step`."""
        f = self._take("raise", step)
        if f is not None:
            exc = getattr(builtins, f.arg or "RuntimeError", RuntimeError)
            raise exc(f"injected fault at step {step}")

    def maybe_delay(self, step: int):
        """Sleep inside the step if scheduled (watchdog-trip path)."""
        f = self._take("delay", step)
        if f is not None:
            time.sleep(float(f.arg or "1.0"))

    def maybe_ckpt_stall(self, step: int):
        """ckpt_io_stall@step:s — stall the background checkpoint writer
        for s seconds before it persists snapshot `step` (slow disk /
        network filesystem hiccup). With the writer wedged, the snapshot
        ring's drop-oldest-pending backpressure path fires."""
        f = self._take("ckpt_io_stall", step)
        if f is not None:
            time.sleep(float(f.arg or "1.0"))

    def maybe_torn_write(self, step: int, path: str):
        """ckpt_torn_write@step — truncate `path` (the step's data file)
        to half its size AFTER the save sequence completed. The manifest
        certifies a file whose bytes no longer match its CRC: invisible to
        latest_step()'s existence checks under
        FLAGS_ckpt_integrity_check=False and to any protocol that trusts
        rename atomicity — only a restore-time CRC pass (the scrubber)
        catches it."""
        f = self._take("ckpt_torn_write", step)
        if f is None:
            return
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(max(size // 2, 1))
        except OSError:
            pass  # injection must never break the real save path

    def maybe_dispatch_fault(self, dispatch_idx: int, kind: str = "dispatch",
                             request_ids=()):
        """Serving-engine injection point, called at the top of every
        supervised jitted dispatch attempt. `dispatch_idx` is the engine's
        running dispatch counter (every attempt — retries included —
        increments it), `kind` names the dispatch flavor ("prefill" /
        "decode" / "predict"), `request_ids` the submit indices riding this
        dispatch. Raises RuntimeError for dispatch_raise / poison_request
        and InjectedDispatchHang for dispatch_hang."""
        for f in self.faults:
            if f.fired or f.step != dispatch_idx:
                continue
            if f.kind == "dispatch_raise":
                f.fired = True
                self.log.append(repr(f))
                raise RuntimeError(
                    f"injected dispatch_raise at {kind} dispatch "
                    f"{dispatch_idx}")
            if f.kind == "dispatch_hang":
                f.fired = True
                self.log.append(repr(f))
                raise InjectedDispatchHang(float(f.arg or "1.0"))
        for rid in request_ids:
            for f in self.faults:
                if f.kind != "poison_request" or f.step != rid:
                    continue
                if f.arg is not None and f.arg != kind:
                    continue
                if not f.fired:     # log once, fire forever (persistent)
                    f.fired = True
                    self.log.append(repr(f))
                raise RuntimeError(
                    f"injected poison: request {rid} at {kind} dispatch "
                    f"{dispatch_idx}")

    def maybe_replica_fault(self, replica_idx: int):
        """Router-tier injection point, polled at the top of
        every replica pump. Clauses key on the replica INDEX, not a step
        counter. Returns None, or a (kind, arg) verdict the replica
        applies to itself: ("crash", None) — hard-crash now, fail every
        in-flight stream (fires once); ("hang", seconds) — make no
        forward progress for that long (fires once; the router watchdog
        must notice); ("slow", ms) — add per-pump latency, persistently
        (logs once, keeps firing)."""
        f = self._take("replica_crash", replica_idx)
        if f is not None:
            return ("crash", None)
        f = self._take("replica_hang", replica_idx)
        if f is not None:
            return ("hang", float(f.arg or "1.0"))
        for f in self.faults:
            if f.kind == "replica_slow" and f.step == replica_idx:
                if not f.fired:     # log once, fire forever (persistent)
                    f.fired = True
                    self.log.append(repr(f))
                return ("slow", float(f.arg or "1.0"))
        return None

    def maybe_swap_stall(self, replica_idx: int) -> Optional[float]:
        """swap_stall@i:s — replica i's in-place weight swap needs s extra
        seconds before its new weights are trustworthy (device transfer
        still landing). Returns the stall seconds (fires once) or None.
        The replica records a not-before timestamp; the deployment
        controller's canary gate must wait it out."""
        f = self._take("swap_stall", replica_idx)
        return None if f is None else float(f.arg or "1.0")

    def maybe_bad_weights(self, deploy_idx: int) -> bool:
        """deploy_bad_weights@n — the n-th deploy this process starts
        loads weights that must fail the canary gate. Polled by the
        DeploymentController AFTER certification succeeds (bad weights
        with a valid manifest are exactly the case the canary exists
        for); the controller NaN-poisons the loaded tree so the golden
        prompts genuinely produce non-finite logits."""
        return self._take("deploy_bad_weights", deploy_idx) is not None

    def maybe_kill(self, step: int, point: str = KILL_POINT_STEP):
        """SIGKILL the current process at a named kill point. Used to
        simulate hard preemption / crash mid-checkpoint; no cleanup
        (atexit, finally) can mask the tear."""
        if self._take("kill", step, point) is not None:
            os.kill(os.getpid(), signal.SIGKILL)
            os._exit(137)   # unreachable: SIGKILL cannot be handled


# process-global plan: lazily built from the environment so library code
# (CheckpointManager kill points) sees the same schedule as the trainer.
_GLOBAL: Optional[FaultPlan] = None


def global_plan() -> FaultPlan:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = FaultPlan.from_env()
    return _GLOBAL


def set_global_plan(plan: Optional[FaultPlan]):
    """Install (or clear, with None) the process-global plan — test hook."""
    global _GLOBAL
    _GLOBAL = plan
