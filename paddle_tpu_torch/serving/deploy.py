"""Zero-downtime rolling weight deployment (counterpart of
paddle_tpu/serving/deploy.py).

`DeploymentController` rolls a certified `WeightSet` across a
`ReplicaRouter` fleet one replica at a time, without dropping a single
admitted stream:

    drain   — the replica leaves placement; its in-flight streams are
              failover-re-prefilled onto same-version survivors (the
              router's failover) or, when it is the last replica of its
              version, left to finish in place while the replica stays
              pumped but placement-excluded
    swap    — `LLMEngine.replace_params`: the model is rebound, under
              the scheduler lock of an idle engine, to tensors whose
              names, shapes, dtypes and devices are checked equal; the
              tensors it held are kept (not copied over) as the
              rollback token
    canary  — golden prompts decode greedily on the contiguous cache
              path: every logits tensor must be finite and the token
              sequences bit-identical to the reference (the manifest's
              golden block, or the first swapped replica)
    readmit — placement sees the replica again; an `SLOBurnMonitor`
              watch window plus a breaker check guard the re-admitted
              replica before the rollout proceeds

The weight set is loaded onto the fleet's device (the first replica's KV
pool's): one set of new tensors that every replica's model is rebound to.

Any canary failure, mid-rollout SLO burn, breaker trip, or drain
timeout triggers an automatic fleet-wide rollback to each replica's
prior weights, after which streams still pinned to the dead version are
retired with a typed, retryable error (`version_retired`). The
controller emits `deploy_started / deploy_swap / deploy_canary_fail /
deploy_rollback / deploy_complete` flight events and the
`pdtpu_deploy_*` metric families.

Version-skew safety is owned by the router (`RouterHandle.weight_version`
pinning + version-aware placement); this module only ever moves streams
through `drain_replica`, which honors it.

Threading mirrors the router: under SimClock the harness interleaves
`controller.pump()` with `router.pump()`; under a real clock `run()`
blocks or `spawn()` pumps from a daemon thread (RouterServer's
POST /deploy uses the latter).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import UncertifiedWeightsError
from ..obs.deploy_metrics import DeployMetrics
from ..obs.flight_recorder import flight_recorder
from ..utils.fault_injection import global_plan
from .clock import Clock, SimClock
from .llm.lora import AdapterError

_log = logging.getLogger("paddle_tpu_torch.serving.deploy")

# golden prompts used when neither the manifest nor the config names any:
# tiny, low-id token sequences valid under any real vocab
_DEFAULT_CANARY_PROMPTS = ((1, 2, 3, 4, 5), (5, 4, 3, 2))


def _nan_poison(tree):
    """deploy_bad_weights fault: every float leaf becomes NaN (a new
    tensor of its shape, dtype and device: `torch.full_like`), so the
    canary's finite-logits gate genuinely fails while the signature is
    untouched: the swap itself still succeeds, as it would with a real
    bad-weights push."""
    if isinstance(tree, dict):
        return {k: _nan_poison(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nan_poison(v) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return torch.full_like(tree, float("nan"))
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype,
                                                      np.floating):
        return np.full_like(tree, np.nan)
    return tree


@dataclass
class DeployConfig:
    canary_prompts: tuple = _DEFAULT_CANARY_PROMPTS   # overridden by the
    #                            weight set's manifest golden block
    canary_max_new_tokens: int = 4
    watch_window_s: float = 1.0    # SLO-burn/breaker watch after readmit
    settle_timeout_s: float = 120.0   # drain must quiesce within this or
    #                            the rollout aborts (rollback, NOT a
    #                            forced eviction — zero-drop wins)
    poll_interval_s: float = 0.005    # pump cadence in live mode
    history: int = 16              # finished rollouts kept for /debug/deploy

    def __post_init__(self):
        if self.canary_max_new_tokens < 1:
            raise ValueError("canary_max_new_tokens must be >= 1")
        if not self.canary_prompts:
            raise ValueError("need at least one canary prompt")
        if self.watch_window_s < 0 or self.settle_timeout_s <= 0:
            raise ValueError("watch_window_s must be >= 0 and "
                             "settle_timeout_s > 0")


class DeploymentController:
    """One rolling deploy at a time over a ReplicaRouter fleet.

    An explicit state machine advanced by `pump()`: per-replica phases
    drain → settle → canary_wait → canary → watch, then the next
    replica; a `rollback` super-phase restores every swapped replica's
    prior weights in the same drain-first, zero-drop manner. All public
    methods are thread-safe."""

    def __init__(self, router, config: Optional[DeployConfig] = None,
                 metrics: Optional[DeployMetrics] = None):
        self.router = router
        self.clock: Clock = router.clock
        self.config = config or DeployConfig()
        self.metrics = metrics or DeployMetrics()
        self._lock = threading.RLock()
        self._job: Optional[Dict[str, Any]] = None
        self._deploy_seq = 0       # lifetime rollouts (fault keying)
        self._history: deque = deque(maxlen=self.config.history)
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def start(self, weightset) -> Dict[str, Any]:
        """Certify + load the weight set and begin a rollout. Raises
        `UncertifiedWeightsError` (typed) when certification fails and
        RuntimeError when a rollout is already in progress or the fleet
        has no live replica. Returns the initial status dict. Advance
        with `pump()` (or use `run()`/`spawn()`)."""
        with self._lock:
            if self._job is not None:
                raise RuntimeError(
                    f"deploy of {self._job['version']!r} already in "
                    "progress; wait for it to finish or roll back")
            manifest = weightset.certify()
            params = weightset.load(
                device=self.router.replicas[0].engine.pool.device)
            plan = global_plan()
            poisoned = (plan is not None
                        and plan.maybe_bad_weights(self._deploy_seq))
            self._deploy_seq += 1
            if poisoned:
                params = _nan_poison(params)
            version = weightset.version
            targets = [r.name for r in self.router.replicas
                       if not r.crashed]
            if not targets:
                raise RuntimeError("no live replica to deploy to")
            prompts = [list(map(int, p))
                       for p in self.config.canary_prompts]
            reference: Optional[List[np.ndarray]] = None
            golden = manifest.get("golden")
            if golden:
                prompts = [list(map(int, p)) for p in golden["prompts"]]
                if golden.get("tokens"):
                    reference = [np.asarray(t, np.int32)
                                 for t in golden["tokens"]]
            burn_baseline: Dict[str, set] = {}
            for r in self.router.replicas:
                burn = getattr(r.engine, "burn", None)
                if burn is not None:
                    burn_baseline[r.name] = set(
                        (burn.snapshot().get("fired") or {}).keys())
            now = self.clock.now()
            self._job = {
                "version": version,
                "params": params,
                "queue": targets,
                "idx": 0,
                "phase": "drain",
                "state": "rolling",
                "error": None,
                "prompts": prompts,
                "reference": reference,
                "prior": {},          # name -> (params, version)
                "swapped": [],        # readmitted on the new version
                "skipped": [],        # crashed mid-rollout
                "burn_baseline": burn_baseline,
                "started_at": now,
                "settle_deadline": None,
                "watch_until": None,
                "rb_queue": [],
                "rb_idx": 0,
                "rb_phase": None,
            }
            self.metrics.on_start(version)
            flight_recorder().record(
                "deploy_started", version=version, replicas=targets,
                prior={r.name: r.weight_version
                       for r in self.router.replicas},
                bad_weights_injected=bool(poisoned))
            return self.status()

    def active(self) -> bool:
        with self._lock:
            return self._job is not None

    def status(self) -> Dict[str, Any]:
        with self._lock:
            if self._job is None:
                return {"state": "idle", "history": list(self._history)}
            job = self._job
            target = None
            if job["state"] == "rolling" and job["idx"] < len(job["queue"]):
                target = job["queue"][job["idx"]]
            elif job["state"] == "rolling_back" \
                    and job["rb_idx"] < len(job["rb_queue"]):
                target = job["rb_queue"][job["rb_idx"]]
            return {"state": job["state"], "version": job["version"],
                    "phase": job["phase"], "target": target,
                    "swapped": list(job["swapped"]),
                    "skipped": list(job["skipped"]),
                    "error": job["error"],
                    "history": list(self._history)}

    def run(self, weightset, timeout_s: Optional[float] = None
            ) -> Dict[str, Any]:
        """Live-mode convenience: start + pump to completion. Returns the
        rollout's history record. Under SimClock drive `pump()` yourself
        alongside `router.pump()` instead."""
        if isinstance(self.clock, SimClock):
            raise RuntimeError(
                "DeploymentController.run() requires a real clock; under "
                "SimClock the harness interleaves pump() itself")
        self.start(weightset)
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while self.active():
            self.pump()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"rollout of {weightset.version!r} still "
                    f"{self.status()['phase']!r} after {timeout_s}s")
            time.sleep(self.config.poll_interval_s)
        return self._history[-1]

    def spawn(self, weightset) -> None:
        """start() synchronously (so certification errors surface to the
        caller), then pump from a daemon thread — the RouterServer
        POST /deploy path."""
        if isinstance(self.clock, SimClock):
            raise RuntimeError("spawn() requires a real clock")
        self.start(weightset)

        def _loop():
            while self.active():
                try:
                    self.pump()
                except Exception:
                    _log.exception("deploy pump failed")
                time.sleep(self.config.poll_interval_s)

        self._thread = threading.Thread(
            target=_loop, name="pdtt-deploy", daemon=True)
        self._thread.start()

    # ---- the state machine ----

    def pump(self) -> None:
        """Advance the rollout one step. Idempotent when idle."""
        with self._lock:
            job = self._job
            if job is None:
                return
            now = self.clock.now()
            try:
                if job["state"] == "rolling_back":
                    self._pump_rollback(job, now)
                    return
                # fleet-wide abort triggers: a breaker trip or a newly
                # fired SLO-burn class on any replica already serving
                # the new version aborts the rollout wherever it stands
                abort = self._abort_reason(job)
                if abort is not None:
                    self._begin_rollback(job, abort, now)
                    return
                self._pump_rolling(job, now)
            except Exception as e:
                _log.exception("deploy pump: rolling back after error")
                if job["state"] == "rolling_back":
                    raise
                flight_recorder().record(
                    "deploy_error", version=job["version"],
                    error=f"{type(e).__name__}: {e}")
                self._begin_rollback(
                    job, f"error:{type(e).__name__}", now)

    # -- rolling --

    def _abort_reason(self, job) -> Optional[str]:
        for name in job["swapped"]:
            r = self.router._replica_by_name(name)
            if r.crashed:
                continue   # crash = failover territory, not weights
            if r.engine.broken:
                return f"breaker_trip:{name}"
            burn = getattr(r.engine, "burn", None)
            if burn is not None:
                fired = set((burn.snapshot().get("fired") or {}).keys())
                fresh = fired - job["burn_baseline"].get(name, set())
                if fresh:
                    return f"slo_burn:{name}:{sorted(fresh)[0]}"
        return None

    def _advance(self, job, now: float):
        """Move to the next replica, or finish the rollout."""
        job["idx"] += 1
        job["settle_deadline"] = None
        job["watch_until"] = None
        if job["idx"] < len(job["queue"]):
            job["phase"] = "drain"
            return
        duration = now - job["started_at"]
        flight_recorder().record(
            "deploy_complete", version=job["version"],
            replicas=list(job["swapped"]), skipped=list(job["skipped"]),
            duration_s=round(duration, 4))
        self.metrics.on_finish("completed", duration)
        self._history.append({
            "version": job["version"], "outcome": "completed",
            "reason": None, "swapped": list(job["swapped"]),
            "skipped": list(job["skipped"]),
            "duration_s": duration})
        self._job = None

    def _skip_target(self, job, name: str, now: float):
        job["skipped"].append(name)
        flight_recorder().record("deploy_skip", version=job["version"],
                                 replica=name, reason="crashed")
        self._advance(job, now)

    def _pump_rolling(self, job, now: float):
        name = job["queue"][job["idx"]]
        target = self.router._replica_by_name(name)
        phase = job["phase"]
        if target.crashed:
            # a replica lost mid-rollout is the failover machinery's
            # problem; the rollout continues over the survivors
            self._skip_target(job, name, now)
            return
        if phase == "drain":
            moved = self.router.drain_replica(name)
            if moved:
                # every moved stream is already re-queued at the router;
                # the engine-side rows are orphans — evict them so the
                # replica quiesces immediately
                target.engine.evacuate("deploy_drain")
            job["settle_deadline"] = now + self.config.settle_timeout_s
            job["phase"] = "settle"
        elif phase == "settle":
            if not target.engine.has_work():
                job["prior"][name] = (target.engine.params,
                                      target.engine.weight_version)
                prior_version = target.engine.weight_version
                target.swap(job["params"], job["version"])
                self.metrics.on_swap()
                flight_recorder().record(
                    "deploy_swap", version=job["version"],
                    replica=name, prior=prior_version)
                job["phase"] = "canary_wait"
            elif now >= job["settle_deadline"]:
                # streams finishing in place did not quiesce in time:
                # abort the rollout rather than evict them (zero-drop
                # beats rollout latency); the target was never swapped,
                # so rollback just readmits it
                self._begin_rollback(job, f"drain_timeout:{name}", now)
        elif phase == "canary_wait":
            if target.swap_ready():
                target.mark_canary()
                job["phase"] = "canary"
        elif phase == "canary":
            self._run_canary(job, target, now)
        elif phase == "watch":
            if now >= job["watch_until"]:
                self._advance(job, now)
        else:  # pragma: no cover - state machine invariant
            raise AssertionError(f"unknown deploy phase {phase!r}")

    def _run_canary(self, job, target, now: float):
        """Golden-prompt gate on the swapped, still-placement-excluded
        replica: finite logits on every step, token sequences
        bit-identical to the reference (manifest golden block, else the
        first swapped replica of this rollout)."""
        name = target.name
        outputs: List[np.ndarray] = []
        fail_reason = None
        for i, prompt in enumerate(job["prompts"]):
            toks, finite = target.engine.canary_probe(
                prompt, self.config.canary_max_new_tokens)
            if not finite:
                fail_reason = f"nonfinite_logits:prompt{i}"
                break
            if job["reference"] is not None:
                ref = job["reference"][i]
                if toks.shape != ref.shape or not np.array_equal(toks, ref):
                    fail_reason = f"reference_mismatch:prompt{i}"
                    break
            outputs.append(toks)
        passed = fail_reason is None
        self.metrics.on_canary(passed)
        if not passed:
            flight_recorder().record(
                "deploy_canary_fail", version=job["version"],
                replica=name, reason=fail_reason)
            self._begin_rollback(job, f"canary_fail:{fail_reason}", now)
            return
        if job["reference"] is None:
            # first replica through the gate defines the rollout's
            # bit-identity reference — replicas 2..N must match exactly
            job["reference"] = outputs
        flight_recorder().record(
            "deploy_canary_pass", version=job["version"], replica=name,
            prompts=len(job["prompts"]))
        self.router.readmit_replica(name)
        job["swapped"].append(name)
        job["watch_until"] = now + self.config.watch_window_s
        job["phase"] = "watch"

    # -- rollback --

    def _begin_rollback(self, job, reason: str, now: float):
        self.metrics.on_rollback(reason)
        job["state"] = "rolling_back"
        job["error"] = reason
        # replicas holding the new weights, newest swap last: everything
        # readmitted on the new version, plus the current target if its
        # swap already happened (canary_wait/canary failure paths) —
        # a target still in drain/settle was never swapped and only
        # needs readmission
        rb = list(job["swapped"])
        if job["idx"] < len(job["queue"]):
            name = job["queue"][job["idx"]]
            if name in job["prior"] and name not in rb:
                rb.append(name)
            elif name not in job["prior"]:
                # drained but never swapped: hand it straight back
                r = self.router._replica_by_name(name)
                if not r.crashed and r.deploy_state != "serving":
                    self.router.readmit_replica(name)
        job["rb_queue"] = rb
        job["rb_idx"] = 0
        job["rb_phase"] = "restore"
        job["phase"] = "rollback"
        flight_recorder().record(
            "deploy_rollback", version=job["version"], reason=reason,
            restoring=rb)
        _log.warning("deploy %s: rolling back (%s)", job["version"],
                     reason)

    def _pump_rollback(self, job, now: float):
        if job["rb_idx"] >= len(job["rb_queue"]):
            self._finish_rollback(job, now)
            return
        name = job["rb_queue"][job["rb_idx"]]
        target = self.router._replica_by_name(name)
        if target.crashed:
            job["rb_idx"] += 1
            job["rb_phase"] = "restore"
            return
        phase = job["rb_phase"]
        if phase == "restore":
            if target.deploy_state == "serving":
                # readmitted on the new version: drain it first, same
                # zero-drop contract as the forward direction — its
                # streams move to surviving new-version replicas or
                # finish in place
                moved = self.router.drain_replica(name)
                if moved:
                    target.engine.evacuate("deploy_rollback_drain")
                job["settle_deadline"] = \
                    now + self.config.settle_timeout_s
                job["rb_phase"] = "rb_settle"
                return
            # failed-canary target: already drained + idle
            self._restore_one(job, target, now)
        elif phase == "rb_settle":
            if not target.engine.has_work():
                self._restore_one(job, target, now)
            elif now >= job["settle_deadline"]:
                # rollback must converge: evict the stragglers (typed
                # rejects) rather than leave the fleet half-versioned
                target.engine.evacuate("deploy_rollback_timeout")
                self._restore_one(job, target, now)

    def _restore_one(self, job, target, now: float):
        name = target.name
        prior_params, prior_version = job["prior"][name]
        try:
            if target.deploy_state != "draining":
                # failed-canary targets sit in "swapping"/"canary";
                # replica.swap() insists on the drained state
                target.drain()
            target.swap(prior_params, prior_version)
            flight_recorder().record(
                "deploy_swap", version=prior_version, replica=name,
                prior=job["version"], rollback=True)
            self.metrics.on_swap()
        except Exception as e:
            # a replica that cannot take its old weights back (breaker
            # open with stuck work, etc.) is left for supervision;
            # recorded, never fatal to the rest of the rollback
            _log.exception("rollback: restoring %s failed", name)
            flight_recorder().record(
                "deploy_rollback_skip", replica=name,
                error=f"{type(e).__name__}: {e}")
        self.router.readmit_replica(name)
        job["rb_idx"] += 1
        job["rb_phase"] = "restore"

    def _finish_rollback(self, job, now: float):
        retired = self.router.retire_version(job["version"])
        if retired:
            self.metrics.on_retired(retired)
        duration = now - job["started_at"]
        flight_recorder().record(
            "deploy_rollback_done", version=job["version"],
            reason=job["error"], restored=list(job["rb_queue"]),
            retired_streams=retired, duration_s=round(duration, 4))
        self.metrics.on_finish("rolled_back", duration)
        self._history.append({
            "version": job["version"], "outcome": "rolled_back",
            "reason": job["error"], "swapped": list(job["swapped"]),
            "skipped": list(job["skipped"]),
            "duration_s": duration})
        self._job = None
        # the black box carries the deploy_canary_fail → deploy_rollback
        # sequence; drop the atomic dump now that the story is complete
        flight_recorder().try_dump(
            reason=f"deploy_rollback:{job['version']}")

    # ---- adapter rollout ----

    def deploy_adapter(self, weightset, adapter_id: Optional[str] = None,
                       alpha: Optional[float] = None) -> Dict[str, Any]:
        """Fleet-wide LoRA adapter rollout — the lightweight sibling of
        `start()`/`pump()`, completing synchronously in one call.

        An adapter swap needs NONE of the base machinery's heavy phases:
        no drain (base weights and every other bank row are untouched —
        in-flight streams keep decoding through the whole rollout), no
        settle (the bank's operand shapes are fixed). Per
        live replica: `register_adapter` rewrites the bank row between
        pump iterations (stashing the prior row as a rollback token),
        then golden prompts greedy-decode THROUGH the adapter
        (`canary_probe(adapter=...)`) — finite logits, and token
        sequences bit-identical to the manifest golden block or to the
        first replica through the gate. Any refusal or canary failure
        rolls the row back on every replica that already took it
        (`rollback_adapter`, newest first), so the fleet is never left
        serving a half-deployed or NaN adapter. Zero streams dropped in
        either direction.

        `weightset` must be an `AdapterWeightSet`; it is certified
        against the fleet's bank signature (`certify_for` — typed
        `adapter_mismatch` refusal on rank/target-module skew).
        `adapter_id` defaults to the weight-set version. Returns the
        history record ({"outcome": "completed" | "rolled_back", ...}).
        """
        with self._lock:
            if self._job is not None:
                raise RuntimeError(
                    f"deploy of {self._job['version']!r} in progress; an "
                    "adapter rollout cannot interleave with a base-weight "
                    "rollout")
            live = [r for r in self.router.replicas if not r.crashed]
            if not live:
                raise RuntimeError("no live replica to deploy to")
            banks = []
            for r in live:
                bank = getattr(r.engine, "adapter_bank", None)
                if bank is None:
                    raise RuntimeError(
                        f"replica {r.name} serves without an adapter bank "
                        "(config.max_adapters=0)")
                banks.append(bank)
            if not hasattr(weightset, "certify_for"):
                raise UncertifiedWeightsError(
                    "adapter rollout requires an AdapterWeightSet "
                    f"(got {type(weightset).__name__}); base WeightSets "
                    "go through start()", reason="bad_format")
            manifest = weightset.certify_for(banks[0].signature)
            # the bank stages host trees onto its own device
            tree = weightset.load(device="cpu")
            aid = str(adapter_id or weightset.version)
            plan = global_plan()
            poisoned = (plan is not None
                        and plan.maybe_bad_weights(self._deploy_seq))
            self._deploy_seq += 1
            if poisoned:
                tree = _nan_poison(tree)
            prompts = [list(map(int, p))
                       for p in self.config.canary_prompts]
            reference: Optional[List[np.ndarray]] = None
            golden = manifest.get("golden")
            if golden:
                prompts = [list(map(int, p)) for p in golden["prompts"]]
                if golden.get("tokens"):
                    reference = [np.asarray(t, np.int32)
                                 for t in golden["tokens"]]
            now = self.clock.now()
            self.metrics.on_start(f"adapter:{aid}")
            flight_recorder().record(
                "adapter_deploy_started", adapter=aid,
                version=weightset.version,
                replicas=[r.name for r in live],
                bad_weights_injected=bool(poisoned))
            snaps: Dict[str, Any] = {}    # name -> rollback token
            order: List[str] = []         # registration order
            done: List[str] = []
            fail: Optional[str] = None
            for r in live:
                try:
                    snaps[r.name] = r.engine.register_adapter(
                        aid, tree, alpha=alpha)
                    order.append(r.name)
                except AdapterError as e:
                    # typed refusal — the row was never written, so this
                    # replica needs no rollback
                    fail = f"register_fail:{r.name}:{e.reason}"
                    break
                outputs: List[np.ndarray] = []
                for i, prompt in enumerate(prompts):
                    toks, finite = r.engine.canary_probe(
                        prompt, self.config.canary_max_new_tokens,
                        adapter=aid)
                    if not finite:
                        fail = f"nonfinite_logits:{r.name}:prompt{i}"
                        break
                    if reference is not None:
                        ref = reference[i]
                        if toks.shape != ref.shape \
                                or not np.array_equal(toks, ref):
                            fail = f"reference_mismatch:{r.name}:prompt{i}"
                            break
                    outputs.append(toks)
                self.metrics.on_canary(fail is None)
                if fail is not None:
                    break
                if reference is None:
                    # first replica through the gate defines bit-identity
                    reference = outputs
                done.append(r.name)
            duration = self.clock.now() - now
            if fail is None:
                flight_recorder().record(
                    "adapter_deploy_complete", adapter=aid,
                    replicas=done, duration_s=round(duration, 4))
                record = {"version": f"adapter:{aid}",
                          "outcome": "completed", "reason": None,
                          "swapped": done, "skipped": [],
                          "duration_s": duration}
                self.metrics.on_finish("completed", duration)
                self._history.append(record)
                return record
            # fleet auto-rollback: every replica whose row was rewritten
            # takes its prior row back (None token = fresh load → unload)
            restored = []
            for name in reversed(order):
                r = self.router._replica_by_name(name)
                if r.crashed:
                    continue
                r.engine.rollback_adapter(aid, snaps[name])
                restored.append(name)
            self.metrics.on_rollback(fail)
            flight_recorder().record(
                "adapter_deploy_rollback", adapter=aid, reason=fail,
                restored=restored, duration_s=round(duration, 4))
            record = {"version": f"adapter:{aid}",
                      "outcome": "rolled_back", "reason": fail,
                      "swapped": done, "skipped": [],
                      "duration_s": duration}
            self.metrics.on_finish("rolled_back", duration)
            self._history.append(record)
            flight_recorder().try_dump(reason=f"adapter_rollback:{aid}")
            return record
