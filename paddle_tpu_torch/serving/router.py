"""Fault-tolerant multi-replica serving tier (counterpart of
paddle_tpu/serving/router.py).

One LLMEngine is a single blast domain: a breaker trip, a hung forward,
or a process loss takes every in-flight stream with it. This module puts
a front-of-fleet router over N engine replicas so the fleet degrades one
replica at a time instead:

- **Routing** is prefix-aware then load-aware: every admission probes
  each healthy replica's radix prefix cache (`LLMEngine.prefix_probe`, a
  read-only walk that moves no refcounts or LRU ticks) and routes to the
  longest block-aligned match, tie-broken by in-flight token load, then
  replica index. Affinity compounds: the replica that served a tenant's
  prefix keeps winning that prefix, so fleet-wide hit rate approaches
  single-engine hit rate instead of 1/N-ing it.

- **Supervision** speaks the existing breaker vocabulary. Each pump the
  router reads replica health (crashed / broken / draining / ok — the
  same words `/healthz` serves) and runs a hung-forward watchdog on the
  engine's dispatch counter. Consecutive watchdog failures, or any
  hard-down state, quarantine the replica; re-admission is probed on an
  exponential backoff ladder so a flapping replica cannot oscillate
  traffic. When the whole fleet is quarantined or saturated the router
  sheds at its own door (RejectedError -> 429 + Retry-After upstream),
  best-effort traffic first.

- **Zero dropped streams.** When a replica dies mid-decode, every
  in-flight stream it owned is re-prefilled on a survivor from the
  tokens already emitted: resubmit concat(prompt, emitted) with the
  remaining token budget. Decoding is greedy (argmax), so the survivor's
  continuation is bit-identical to what the dead replica would have
  produced — the stitched stream equals an uninterrupted single-engine
  `generate()` exactly, regardless of where the failure landed. Each
  resumed stream is recorded as a `router_failover` flight event naming
  the dead replica and the rid, in submit order.

Replicas are in-process (`InProcessReplica`): the engine pump split off
the HTTP front end, so N replicas run under one SimClock and the whole
failover dance is scripted-time deterministic in tests. `RouterServer`
is the HTTP face (same /generate contract as `ServingServer`, plus
fleet-level /healthz and pdtpu_router_* /metrics). Each replica's engine
owns its model: a weight swap rebinds that model's tensors (see
`LLMEngine.replace_params`), so the router refuses two replicas whose
engines share one model object. On one card the replicas' scheduler
threads launch onto the same device.

Prefill/decode disaggregation: replicas carry a role
(`prefill` / `decode` / `mixed`). A stream that finishes prefill on a
prefill-role replica exports its KV row + sampling lane atomically
(`LLMEngine.export_stream`) and is re-placed decode-first with the
staged payload, paying a one-token prefill on the destination instead
of recomputing the prompt. The staged KV stays on the handle until the
stream completes, so a decode replica crashing right after the handoff
re-places the SAME payload — and when it has gone stale (tokens emitted
since), the stream falls back to the ordinary failover re-prefill.
Role preference is exactly that — a preference: every healthy replica
stays in the ranked candidate list, because zero dropped streams beats
role purity.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.flight_recorder import flight_recorder
from ..obs.trace import new_request_id
from ..utils.fault_injection import FaultPlan, global_plan
from .clock import Clock, SimClock
from .engine import DeadlineExceededError, RejectedError
from .llm.sampling import SamplingParams
from .metrics import RouterMetrics, SLO_CLASSES
from .server import (HTTPServer, JsonHandler, parse_generate,
                     read_request_body)

_log = logging.getLogger("paddle_tpu_torch.serving.router")


# ---------------------------------------------------------------------------
# replica: engine pump split off the HTTP front end


class InProcessReplica:
    """One LLMEngine as a routable fleet member.

    Wraps the engine with an identity (index/name), a crash switch, and
    the replica-tier fault injection point (`replica_crash@i`,
    `replica_hang@i:s`, `replica_slow@i:ms` — keyed on the replica INDEX,
    polled at the top of every pump). Under SimClock the router pumps the
    engine through here; under MonotonicClock the engine runs its own
    scheduler thread and `pump()` only applies faults and observes
    progress for the hung-forward watchdog."""

    def __init__(self, engine, index: int, name: Optional[str] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 role: str = "mixed"):
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'mixed', got "
                f"{role!r}")
        self.engine = engine
        self.index = int(index)
        self.name = name or f"replica{index}"
        self.role = role
        self.clock: Clock = engine.clock
        self._fault_plan = fault_plan
        self.crashed = False
        self._hang_until: Optional[float] = None
        self.last_progress = self.clock.now()
        self._seen_idx = engine._dispatch_idx
        # rolling-deploy lifecycle: serving | draining |
        # swapping | canary. Any non-serving state excludes the replica
        # from placement (health() != "ok") but — unlike quarantine —
        # keeps it pumped, so streams finishing in place still decode.
        self.deploy_state = "serving"
        self._swap_ready_at: Optional[float] = None

    # -- health vocabulary (same words /healthz speaks) --

    def health(self) -> str:
        if self.crashed:
            return "crashed"
        if self.engine.broken:
            return "broken"
        if self.engine.draining:
            return "draining"
        if self.deploy_state != "serving":
            # deploy lifecycle word: "draining" / "swapping" / "canary"
            return self.deploy_state
        return "ok"

    @property
    def weight_version(self) -> str:
        return self.engine.weight_version

    # -- routing inputs --

    def prefix_probe(self, prompt, tenant: Optional[str] = None,
                     adapter: Optional[str] = None) -> int:
        if self.crashed:
            return 0
        return self.engine.prefix_probe(prompt, tenant=tenant,
                                        adapter=adapter)

    def inflight_tokens(self) -> int:
        if self.crashed:
            return 1 << 30
        return self.engine.inflight_tokens()

    # -- admission --

    def submit(self, *args, **kwargs):
        if self.crashed:
            raise RejectedError(
                f"replica {self.name} is down", reason="replica_down",
                retry_after_s=1.0)
        return self.engine.submit(*args, **kwargs)

    def export_stream(self, rid: str) -> dict:
        """Atomic KV + lane export for a prefill→decode handoff
       . ValueError propagates when the stream is still
        mid-prefill; RuntimeError when the replica is down."""
        if self.crashed:
            raise RuntimeError(f"replica {self.name} is down")
        return self.engine.export_stream(rid)

    # -- lifecycle --

    def crash(self):
        """Hard-kill analog: the replica stops answering anything. A live
        engine thread is torn down (a dead process stops computing);
        under SimClock the engine is simply never pumped again — either
        way in-flight state is abandoned exactly as a process loss would
        abandon it, and only the handles' already-emitted tokens survive
        for the router to re-prefill from."""
        if self.crashed:
            return
        self.crashed = True
        if getattr(self.engine, "_thread", None) is not None:
            try:
                self.engine.stop(drain=False, timeout=10.0)
            except Exception:
                _log.exception("replica %s: engine stop after crash failed",
                               self.name)

    # -- rolling-deploy lifecycle --

    def drain(self):
        """Enter deploy-drain: placement skips this replica from now on
        (health() reads "draining") while it keeps being pumped, so any
        stream the router chose to leave in place decodes to completion.
        The router's `drain_replica` is the entry point — it also moves
        movable streams; call that, not this, unless testing."""
        if self.crashed:
            raise RuntimeError(f"replica {self.name} is crashed")
        self.deploy_state = "draining"

    def swap(self, params, version: str):
        """Weight swap on a drained, idle replica. Applies the
        `swap_stall@i:s` fault clause (the new weights need s more
        seconds to be trustworthy — `swap_ready()` gates the canary),
        then delegates to the engine's signature-checked
        `replace_params`, which rebinds the model to the new tensors and
        never writes the ones it held: the controller keeps those as the
        rollback token."""
        if self.crashed:
            raise RuntimeError(f"replica {self.name} is crashed")
        if self.deploy_state != "draining":
            raise RuntimeError(
                f"replica {self.name} must be draining to swap "
                f"(deploy_state={self.deploy_state!r})")
        plan = (self._fault_plan if self._fault_plan is not None
                else global_plan())
        if plan is not None:
            stall = plan.maybe_swap_stall(self.index)
            if stall is not None:
                self._swap_ready_at = self.clock.now() + float(stall)
        self.engine.replace_params(params, version)
        self.deploy_state = "swapping"

    def swap_ready(self) -> bool:
        """True once any injected swap stall has elapsed."""
        if self._swap_ready_at is None:
            return True
        if self.clock.now() >= self._swap_ready_at:
            self._swap_ready_at = None
            return True
        return False

    def mark_canary(self):
        self.deploy_state = "canary"

    def readmit(self):
        """Leave the deploy lifecycle: placement sees the replica again."""
        self.deploy_state = "serving"
        self._swap_ready_at = None

    def observe_progress(self, now: float):
        """Watchdog input: the dispatch counter moved, or there is
        nothing to dispatch — either counts as forward progress."""
        idx = self.engine._dispatch_idx
        if idx != self._seen_idx or not self.engine.has_work():
            self._seen_idx = idx
            self.last_progress = now

    def pump(self) -> int:
        """One supervised scheduling step. Applies replica-tier faults,
        then pumps the engine (SimClock mode) or just observes its
        progress (threaded mode). Returns retired-token count (0 while
        crashed or inside an injected hang window)."""
        if self.crashed:
            return 0
        plan = (self._fault_plan if self._fault_plan is not None
                else global_plan())
        if plan is not None:
            verdict = plan.maybe_replica_fault(self.index)
            if verdict is not None:
                kind, arg = verdict
                if kind == "crash":
                    self.crash()
                    return 0
                if kind == "hang":
                    self._hang_until = self.clock.now() + float(arg)
                elif kind == "slow" and not isinstance(self.clock, SimClock):
                    time.sleep(float(arg) / 1e3)
        if self._hang_until is not None:
            if self.clock.now() < self._hang_until:
                # frozen forward: no engine pump, no progress — exactly
                # what the watchdog is built to notice
                return 0
            self._hang_until = None
        if getattr(self.engine, "_thread", None) is not None:
            self.observe_progress(self.clock.now())
            return 0
        n = self.engine.pump()
        self.observe_progress(self.clock.now())
        return n


# ---------------------------------------------------------------------------
# per-stream state the router owns across replica deaths


class RouterHandle:
    """Fleet-level streaming view + completion future.

    Mirrors GenerationHandle's surface (`tokens_so_far`, `result`,
    `ttft_ms`, `rid`) but survives the replica it is decoding on: the
    router re-attaches it across failovers, stitching tokens harvested
    from dead replicas (`_prefix`) ahead of the live attachment's
    stream. The future resolves with the full np.int32 array — by greedy
    determinism, identical to an uninterrupted single-engine run."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 eos_token_id: Optional[int], slo: str, tenant: str,
                 rid: str, seq: int, deadline_abs: Optional[float],
                 sampling: Optional[SamplingParams] = None,
                 logprobs: bool = False,
                 adapter: Optional[str] = None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.slo = slo
        self.tenant = tenant
        self.rid = rid
        self.sampling = sampling            # per-request seeded sampling
        #                                     params; carried
        #                                     across failovers unchanged
        self.adapter = adapter              # LoRA adapter id;
        #                                     carried across failovers so
        #                                     the survivor decodes through
        #                                     the same bank row
        self.future: Future = Future()
        self.ttft_ms: Optional[float] = None
        self.failovers = 0                  # replica deaths survived
        self.weight_version: Optional[str] = None   # pinned at placement;
        #                                     FROZEN once any token was
        #                                     emitted — a stream is never
        #                                     stitched across two weight
        #                                     sets
        self.want_logprobs = bool(logprobs)   # per-token logprob surface
        self._seq = seq                     # router submit order
        self._deadline_abs = deadline_abs
        self._prefix = np.empty(0, np.int32)   # harvested off dead replicas
        self._logprobs: List[Optional[float]] = []   # stitched with _prefix
        self._inner = None                  # live GenerationHandle or None
        self._replica: Optional[InProcessReplica] = None
        # prefill→decode disaggregation: the exported KV row +
        # sampling lane ride the handle until the stream completes, so a
        # decode replica crashing right after a handoff re-places the
        # same payload instead of re-prefilling. _resume_args drops them
        # once stale (tokens emitted since the export).
        self._staged_kv: Optional[dict] = None
        self._staged_lane: Optional[dict] = None
        self._handoff_src: Optional[str] = None   # set export→first place
        self._handoff_t0: Optional[float] = None

    def tokens_so_far(self) -> List[int]:
        live = self._inner.tokens_so_far() if self._inner is not None else []
        return [int(t) for t in self._prefix] + list(live)

    def logprobs_so_far(self) -> List[Optional[float]]:
        """Per-emitted-token logprobs, stitched across failovers and
        handoffs exactly like `tokens_so_far` (index-aligned with it).
        All-None unless the stream was submitted with logprobs=True."""
        live = (self._inner.logprobs_so_far()
                if self._inner is not None else [])
        return list(self._logprobs) + list(live)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self.future.result(timeout)

    # -- router internals --

    def _absorb_inner(self):
        """Pull everything the current attachment emitted into the
        stitched prefix and detach. Safe on a dead replica: tokens
        stream into the handle as decode iterations retire, so the list
        is exactly what was produced before the failure froze it."""
        if self._inner is None:
            return
        toks = np.asarray(self._inner.tokens_so_far(),
                          np.int32).reshape(-1)
        if toks.size:
            self._prefix = np.concatenate([self._prefix, toks])
            self._logprobs.extend(
                self._inner.logprobs_so_far()[:toks.size])
        if self.ttft_ms is None:
            self.ttft_ms = self._inner.ttft_ms
        self._inner = None
        self._replica = None

    def _finished(self) -> bool:
        if self._prefix.size >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and self._prefix.size > 0
                and int(self._prefix[-1]) == self.eos_token_id)

    def _resume_args(self, now: float) -> dict:
        """submit() kwargs that continue this stream on a survivor:
        re-prefill prompt+emitted, decode only the remaining budget.

        Speculative decoding: the engine only ever surfaces
        VERIFIED tokens on its handles — unverified draft tokens live in
        the dead replica's draft pool, never in tokens_so_far() — so a
        stream killed mid-draft-window resumes from exactly the accepted
        stream here, and the survivor (spec-enabled or not) re-enters
        draft mode from a clean committed length. Greedy determinism then
        keeps the resumed stream bit-identical to an uninterrupted one.

        Seeded sampling: determinism across failover now also
        requires restoring the RNG-lane counter — `sample_offset` tells
        the survivor that `_prefix.size` stream tokens were already
        drawn, so its first emission uses stream index `_prefix.size`
        of lane `(seed, ·)`, exactly the draw the dead replica would
        have made next. The engine re-derives the grammar DFA state by
        walking the resumed prompt's emitted tail host-side, so a
        constrained stream resumes mid-object without ever re-emitting
        or skipping a token."""
        prompt = (np.concatenate([self.prompt, self._prefix])
                  if self._prefix.size else self.prompt)
        deadline_ms = None
        if self._deadline_abs is not None:
            deadline_ms = max(1.0, (self._deadline_abs - now) * 1e3)
        args = dict(prompt=prompt,
                    max_new_tokens=self.max_new_tokens - self._prefix.size,
                    eos_token_id=self.eos_token_id,
                    deadline_ms=deadline_ms, slo=self.slo,
                    tenant=self.tenant, rid=self.rid,
                    sampling=self.sampling,
                    sample_offset=int(self._prefix.size),
                    logprobs=self.want_logprobs,
                    adapter=self.adapter)
        # disaggregation: attach the staged KV row when it
        # still covers exactly prompt'.size - 1 tokens (the one-token-
        # prefill invariant); anything else means tokens were emitted
        # since the export and the ordinary re-prefill path takes over.
        if self._staged_kv is not None:
            if int(self._staged_kv["length"]) == int(prompt.size) - 1:
                args["kv_row"] = self._staged_kv
            else:
                self._staged_kv = None
                self._staged_lane = None
        lane = self._staged_lane
        if (lane is not None
                and int(lane.get("next_index", -1)) == self._prefix.size):
            args["lane"] = lane
        return args


class _ReplicaState:
    """Router-side supervision record for one replica."""
    __slots__ = ("failures", "quarantined", "next_probe", "backoff_level")

    def __init__(self):
        self.failures = 0          # consecutive watchdog strikes
        self.quarantined = False
        self.next_probe = 0.0      # clock instant of next re-admission try
        self.backoff_level = 0


@dataclass
class RouterConfig:
    hung_timeout_s: float = 30.0   # no dispatch progress with work queued
    quarantine_threshold: int = 3  # consecutive watchdog strikes to trip
    backoff_base_s: float = 1.0    # first re-admission probe delay
    backoff_max_s: float = 60.0    # backoff ladder cap
    retry_after_s: float = 1.0     # backpressure hint on router-level sheds
    poll_interval_s: float = 0.005   # supervision loop period (live mode)
    degraded_shed_fraction: float = 0.5   # quarantined fraction at which
    #                                       best_effort sheds at the door

    def __post_init__(self):
        if self.hung_timeout_s <= 0:
            raise ValueError(
                f"hung_timeout_s must be > 0, got {self.hung_timeout_s}")
        if self.quarantine_threshold < 1:
            raise ValueError(f"quarantine_threshold must be >= 1, got "
                             f"{self.quarantine_threshold}")
        if self.backoff_base_s <= 0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s")
        if not (0.0 < self.degraded_shed_fraction <= 1.0):
            raise ValueError(f"degraded_shed_fraction must be in (0, 1], got "
                             f"{self.degraded_shed_fraction}")


class ReplicaRouter:
    """Front-of-fleet router: prefix/load-aware placement, breaker-aware
    supervision with quarantine + backoff re-admission, and failover
    re-prefill that never drops an admitted stream.

    Threading mirrors the engine: under SimClock the harness advances
    the clock and calls `pump()`; under MonotonicClock `start()` runs
    the same pump from a supervision thread while each replica engine
    runs its own scheduler thread."""

    def __init__(self, replicas: List[InProcessReplica],
                 config: Optional[RouterConfig] = None,
                 metrics: Optional[RouterMetrics] = None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        # distinct MonotonicClock instances all read the same wall; only
        # scripted SimClocks must literally be the same object
        if any(isinstance(r.clock, SimClock) for r in replicas) and \
                len({id(r.clock) for r in replicas}) != 1:
            raise ValueError(
                "SimClock replicas must share one clock instance")
        # a swap rebinds the engine's model in place: two replicas on one
        # model object would swap (and roll back) together
        if len({id(r.engine.model) for r in replicas}) != len(replicas):
            raise ValueError(
                "replicas must not share a model object: a weight swap "
                "rebinds the engine's model")
        self.replicas = replicas
        self.clock: Clock = replicas[0].clock
        self.config = config or RouterConfig()
        self.metrics = metrics or RouterMetrics()
        self._lock = threading.RLock()
        self._state: Dict[str, _ReplicaState] = {
            r.name: _ReplicaState() for r in replicas}
        self._inflight: Dict[str, RouterHandle] = {}   # rid -> handle
        self._pending: List[RouterHandle] = []   # awaiting (re)placement
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._stopped = False

    # ---- admission ----

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               slo: Optional[str] = None,
               tenant: Optional[str] = None,
               rid: Optional[str] = None,
               sampling: Optional[SamplingParams] = None,
               logprobs: bool = False,
               adapter: Optional[str] = None) -> RouterHandle:
        """Admit one prompt to the fleet. Raises RejectedError with
        reason `fleet_unavailable` when every replica is quarantined,
        `shed` when the fleet is degraded past the shed fraction and the
        request is best_effort, or the chosen replica's own reject when
        every healthy replica refuses admission. `sampling`
        rides the handle across failovers: re-placements resubmit the
        same params plus the emitted-token count as `sample_offset`, so
        a seeded stream stays bit-identical across replica deaths.
        `logprobs` surfaces the model's per-token logprob for
        every emitted token on `logprobs_so_far()`, stitched across
        failovers and handoffs like the tokens themselves. `adapter`
        decodes the stream through that LoRA bank row on
        whichever replica accepts it — the id rides the handle, so a
        failover resubmits it and the survivor restores the adapter."""
        if sampling is not None:
            sampling.validate()
        ecfg = self.replicas[0].engine.config
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        mnt = (ecfg.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        slo = ecfg.default_slo if slo is None else slo
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo must be one of {SLO_CLASSES}, got {slo!r}")
        tenant = ecfg.default_tenant if tenant is None else tenant
        rid = rid or new_request_id()
        eos = ecfg.eos_token_id if eos_token_id is None else eos_token_id
        now = self.clock.now()
        deadline_abs = None if deadline_ms is None else now + deadline_ms / 1e3
        with self._lock:
            if self._stopped:
                raise RejectedError("router is stopped; request rejected",
                                    reason="draining")
            self.metrics.on_submit()
            down = sum(1 for r in self.replicas
                       if self._state[r.name].quarantined
                       or r.health() != "ok")
            if down == len(self.replicas):
                self.metrics.on_reject("fleet_unavailable")
                flight_recorder().record("router_reject", rid=rid,
                                         reason="fleet_unavailable")
                raise RejectedError(
                    "every replica is quarantined or unhealthy; fleet "
                    "unavailable", reason="fleet_unavailable",
                    retry_after_s=self.config.retry_after_s)
            if (down / len(self.replicas)
                    >= self.config.degraded_shed_fraction
                    and slo == "best_effort"):
                # graceful degradation: with half the fleet gone the
                # survivors' headroom belongs to interactive/batch SLOs —
                # shed best_effort at the router's own door
                self.metrics.on_reject("shed")
                flight_recorder().record("router_reject", rid=rid,
                                         reason="shed", degraded=down)
                raise RejectedError(
                    f"fleet degraded ({down}/{len(self.replicas)} replicas "
                    "down); best_effort shed at router", reason="shed",
                    retry_after_s=self.config.retry_after_s)
            handle = RouterHandle(prompt, mnt, eos, slo, tenant, rid,
                                  self._seq, deadline_abs,
                                  sampling=sampling, logprobs=logprobs,
                                  adapter=adapter)
            self._seq += 1
            replica, last_exc = self._place_locked(handle, now)
            if replica is None:
                reason = getattr(last_exc, "reason", "fleet_unavailable") \
                    if last_exc is not None else "fleet_unavailable"
                self.metrics.on_reject(reason)
                flight_recorder().record("router_reject", rid=rid,
                                         reason=reason)
                if last_exc is not None:
                    raise last_exc
                raise RejectedError(
                    "no replica accepted the request",
                    reason="fleet_unavailable",
                    retry_after_s=self.config.retry_after_s)
            self._inflight[rid] = handle
        return handle

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None,
                 slo: Optional[str] = None,
                 tenant: Optional[str] = None,
                 sampling: Optional[SamplingParams] = None) -> np.ndarray:
        """Synchronous convenience: submit + wait (live mode only —
        under SimClock nothing pumps while you block)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_token_id=eos_token_id,
                           deadline_ms=deadline_ms, slo=slo,
                           tenant=tenant,
                           sampling=sampling).result(timeout)

    # ---- routing policy ----

    def _candidates_locked(self) -> List[InProcessReplica]:
        return [r for r in self.replicas
                if not self._state[r.name].quarantined
                and r.health() == "ok"]

    def _place_locked(self, handle: RouterHandle, now: float
                      ) -> Tuple[Optional[InProcessReplica],
                                 Optional[Exception]]:
        """Route + admit: candidates ranked by longest block-aligned
        prefix match, then lightest in-flight token load, then index.
        Tries the ranked list in order so one replica's queue_full does
        not fail an admission another replica could take.

        Version-skew safety: once a stream has emitted tokens
        its pinned `weight_version` is frozen, and only same-version
        replicas qualify — resuming the emitted prefix under different
        weights would stitch two weight sets into one stream. A stream
        with no tokens yet may re-pin (there is nothing to stitch).

        Role preference: a stream carrying staged handoff KV
        prefers decode > mixed > prefill; a stream that must (re)prefill
        prefers prefill > mixed > decode. The preference ranks AHEAD of
        the prefix probe but never filters: every healthy same-version
        replica stays a candidate, so an all-mixed fleet ranks exactly
        as before and a role-specialized fleet still places everything
        somewhere rather than dropping a stream.
        Returns the accepting replica, or (None, last_reject)."""
        args = handle._resume_args(now)
        pinned = (handle.weight_version
                  if handle._prefix.size > 0 else None)
        staged = "kv_row" in args

        def role_rank(r: InProcessReplica) -> int:
            if r.role == "mixed":
                return 1
            if staged:
                return 0 if r.role == "decode" else 2
            return 0 if r.role == "prefill" else 2

        ranked = sorted(
            ((role_rank(r),
              -(r.prefix_probe(args["prompt"], tenant=handle.tenant,
                               adapter=handle.adapter)),
              r.inflight_tokens(), r.index, r)
             for r in self._candidates_locked()
             if pinned is None or r.weight_version == pinned),
            key=lambda t: t[:4])
        last_exc: Optional[Exception] = None
        for _rank, neg_match, _, _, r in ranked:
            try:
                inner = r.submit(**args)
            except RejectedError as e:
                last_exc = e
                continue
            handle._inner = inner
            handle._replica = r
            handle.weight_version = r.weight_version
            self.metrics.on_route(r.name, prefix_hit=neg_match < 0)
            if handle._handoff_src is not None:
                src = handle._handoff_src
                handle._handoff_src = None
                if staged:
                    t0 = (handle._handoff_t0
                          if handle._handoff_t0 is not None else now)
                    ms = max(0.0, (now - t0) * 1e3)
                    self.metrics.on_handoff(src, r.name, ms)
                    flight_recorder().record(
                        "router_handoff", rid=handle.rid, src=src,
                        dst=r.name, ms=round(ms, 3),
                        kv_tokens=int(args["kv_row"]["length"]))
                else:
                    # staged KV went stale before a destination accepted
                    # the stream: it re-prefilled instead (still bit-
                    # identical, just not a KV handoff)
                    self.metrics.on_handoff_failed()
                    flight_recorder().record(
                        "router_handoff", rid=handle.rid, src=src,
                        dst=r.name, fallback="re_prefill")
            return r, None
        return None, last_exc

    # ---- supervision ----

    def _quarantine_locked(self, r: InProcessReplica, st: _ReplicaState,
                           reason: str, now: float):
        st.quarantined = True
        st.failures = 0
        st.backoff_level = 0
        st.next_probe = now + self.config.backoff_base_s
        self.metrics.on_quarantine(r.name)
        flight_recorder().record("router_quarantine", replica=r.name,
                                 reason=reason,
                                 next_probe_s=round(st.next_probe - now, 3))
        _log.warning("router: quarantined %s (%s)", r.name, reason)
        self._failover_locked(r, now, reason)

    def _failover_locked(self, r: InProcessReplica, now: float, reason: str):
        """Zero dropped streams: every in-flight stream the dead replica
        owned is harvested (emitted tokens -> stitched prefix) and
        queued for re-prefill on a survivor, in submit order."""
        victims = sorted(
            (h for h in self._inflight.values() if h._replica is r),
            key=lambda h: h._seq)
        resumed = []
        for h in victims:
            h._absorb_inner()
            h.failovers += 1
            if h._finished():
                # the dead replica had already emitted the full stream;
                # nothing to resume — resolve from the harvest
                h.future.set_result(h._prefix.copy())
                self.metrics.on_complete()
                del self._inflight[h.rid]
            else:
                self._pending.append(h)
                resumed.append(h)
        for h in resumed:
            flight_recorder().record(
                "router_failover", replica=r.name, rid=h.rid,
                reason=reason, emitted=int(h._prefix.size),
                remaining=int(h.max_new_tokens - h._prefix.size))
        if victims:
            self.metrics.on_failover(r.name, len(resumed))
            flight_recorder().try_dump(reason=f"router_failover:{r.name}")

    def _supervise_locked(self, now: float):
        cfg = self.config
        for r in self.replicas:
            st = self._state[r.name]
            r.observe_progress(now)
            if st.quarantined:
                if now < st.next_probe:
                    continue
                # re-admission probe: health must read ok, and (SimClock
                # mode) one probe pump must show actual forward progress
                # — a hung replica reads "ok" the whole time it is
                # frozen, and re-admitting it would just restart the
                # watchdog ladder and flap traffic
                ok = r.health() == "ok"
                if ok and getattr(r.engine, "_thread", None) is None:
                    before = r.engine._dispatch_idx
                    r.pump()
                    ok = (r.health() == "ok"
                          and (r.engine._dispatch_idx != before
                               or not r.engine.has_work()))
                if ok:
                    st.quarantined = False
                    st.failures = 0
                    st.backoff_level = 0
                    r.last_progress = now   # a fresh watchdog epoch
                    self.metrics.on_readmit(r.name)
                    flight_recorder().record("router_readmit",
                                             replica=r.name)
                    _log.info("router: re-admitted %s", r.name)
                else:
                    st.backoff_level += 1
                    delay = min(cfg.backoff_base_s * (2 ** st.backoff_level),
                                cfg.backoff_max_s)
                    st.next_probe = now + delay
                continue
            h = r.health()
            if h != "ok":
                if (r.deploy_state != "serving" and not r.crashed
                        and not r.engine.broken
                        and not r.engine.draining):
                    # controller-owned deploy lifecycle, NOT a fault:
                    # placement already skips the replica; its streams
                    # either moved at drain time or are finishing in
                    # place. Quarantining would stop pumping it and
                    # freeze those streams mid-decode.
                    st.failures = 0
                    continue
                self._quarantine_locked(r, st, reason=h, now=now)
                continue
            hung = (r.engine.has_work()
                    and (now - r.last_progress) > cfg.hung_timeout_s)
            if hung:
                st.failures += 1
                if st.failures >= cfg.quarantine_threshold:
                    self._quarantine_locked(r, st, reason="hung", now=now)
            else:
                st.failures = 0

    def _place_pending_locked(self, now: float):
        still: List[RouterHandle] = []
        for h in self._pending:
            if h._deadline_abs is not None and now >= h._deadline_abs:
                h.future.set_exception(DeadlineExceededError(
                    f"request {h.rid} deadline passed while awaiting "
                    "failover placement"))
                self.metrics.on_fail()
                self._inflight.pop(h.rid, None)
                continue
            replica, _ = self._place_locked(h, now)
            if replica is None:
                still.append(h)   # zero dropped: keep trying every pump
        self._pending = still

    def _handoff_locked(self, now: float):
        """Prefill/decode disaggregation: any stream that has
        finished prefill on a prefill-role replica (its handle shows
        emitted tokens but the stream is still live) exports its KV row
        + sampling lane in one atomic engine call, absorbs the emitted
        tokens into the stitched prefix, and is re-placed decode-first
        with the staged payload. A stream that cannot place right now
        goes to `_pending` with the payload intact — zero dropped
        streams, the handoff just completes on a later pump."""
        if all(r.role != "prefill" for r in self.replicas):
            return
        for h in list(self._inflight.values()):
            r = h._replica
            if (r is None or r.role != "prefill" or r.crashed
                    or h._inner is None or h._inner.future.done()):
                continue
            try:
                payload = r.export_stream(h.rid)
            except (ValueError, RuntimeError):
                continue   # mid-prefill (or replica just died): next pump
            h._handoff_src = r.name
            h._handoff_t0 = now
            h._absorb_inner()
            h._staged_kv = payload["kv_row"]
            h._staged_lane = payload["lane"]
            if h._finished():
                # prefill emitted everything the budget allowed (e.g.
                # max_new_tokens == 1): nothing to hand off
                h._handoff_src = None
                h.future.set_result(h._prefix.copy())
                self.metrics.on_complete()
                del self._inflight[h.rid]
                continue
            replica, _ = self._place_locked(h, now)
            if replica is None:
                self._pending.append(h)

    def _harvest_locked(self, now: float):
        for rid, h in list(self._inflight.items()):
            inner = h._inner
            if inner is None:
                continue
            if h.ttft_ms is None and inner.ttft_ms is not None:
                h.ttft_ms = inner.ttft_ms
            if not inner.future.done():
                continue
            exc = inner.future.exception()
            if exc is not None:
                r = h._replica
                if r is not None and (r.crashed or r.health() != "ok"):
                    # replica-scoped failure (breaker trip flushed its
                    # actives, crash, drain): supervision will quarantine
                    # and fail the stream over — not a stream error
                    continue
                h.future.set_exception(exc)
                if isinstance(exc, RejectedError):
                    self.metrics.on_reject(getattr(exc, "reason", "rejected"))
                else:
                    self.metrics.on_fail()
                del self._inflight[rid]
            else:
                toks = np.asarray(inner.future.result(),
                                  np.int32).reshape(-1)
                full = (np.concatenate([h._prefix, toks])
                        if h._prefix.size else toks)
                h.future.set_result(full)
                self.metrics.on_complete()
                del self._inflight[rid]

    def _update_gauges_locked(self):
        for r in self.replicas:
            st = self._state[r.name]
            state = "quarantined" if st.quarantined else r.health()
            inflight = 0 if r.crashed else r.engine.inflight_tokens()
            self.metrics.set_replica(r.name, state, inflight,
                                     weight_version=r.weight_version,
                                     role=r.role)

    # ---- rolling-deploy lifecycle ----

    def _replica_by_name(self, name: str) -> InProcessReplica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise ValueError(f"no replica named {name!r} "
                         f"(fleet: {[r.name for r in self.replicas]})")

    def drain_replica(self, name: str) -> int:
        """Deploy-drain one replica: exclude it from placement, then move
        its in-flight streams — failover re-prefill, zero dropped — onto
        survivors IF a same-version healthy destination exists. When the
        draining replica is the last of its version (the final replica of
        a rollout), its streams are deliberately left attached to finish
        in place: the replica keeps being pumped while placement-
        excluded, which is the only way to honor both zero-drop and the
        never-stitch-versions invariant at once. Returns streams moved;
        the DeploymentController evacuates the engine's orphaned rows
        iff > 0."""
        with self._lock:
            r = self._replica_by_name(name)
            r.drain()
            dest = [c for c in self._candidates_locked()
                    if c.weight_version == r.weight_version]
            in_place = sum(1 for h in self._inflight.values()
                           if h._replica is r)
            moved = 0
            if dest:
                victims = sorted(
                    (h for h in self._inflight.values()
                     if h._replica is r),
                    key=lambda h: h._seq)
                for h in victims:
                    h._absorb_inner()
                    h.failovers += 1
                    if h._finished():
                        h.future.set_result(h._prefix.copy())
                        self.metrics.on_complete()
                        del self._inflight[h.rid]
                    else:
                        self._pending.append(h)
                        moved += 1
                        flight_recorder().record(
                            "router_failover", replica=r.name, rid=h.rid,
                            reason="deploy_drain",
                            emitted=int(h._prefix.size),
                            remaining=int(h.max_new_tokens
                                          - h._prefix.size))
                in_place = 0
                if moved:
                    self.metrics.on_failover(r.name, moved)
            flight_recorder().record(
                "deploy_drain", replica=r.name, moved=moved,
                finish_in_place=in_place, version=r.weight_version)
            return moved

    def readmit_replica(self, name: str):
        """Return a replica from the deploy lifecycle to placement, on a
        fresh watchdog epoch (swap + canary time must not count as hung
        time) and cleared of any quarantine."""
        with self._lock:
            r = self._replica_by_name(name)
            st = self._state[r.name]
            r.readmit()
            st.failures = 0
            st.quarantined = False
            st.backoff_level = 0
            r.last_progress = self.clock.now()
            self.metrics.on_readmit(r.name)
            flight_recorder().record("router_readmit", replica=r.name,
                                     deploy=True,
                                     version=r.weight_version)

    def retire_version(self, version: str) -> int:
        """Rollback cleanup: a pending stream pinned to `version` that
        has already emitted tokens can never resume once the fleet rolled
        back — resuming it under the restored weights would stitch two
        weight sets. Fail those few streams with a typed, retryable
        error (the client re-submits and gets a clean run on the restored
        version); pinned-but-empty streams just lose their pin and place
        normally. Returns streams retired."""
        with self._lock:
            kept: List[RouterHandle] = []
            retired = 0
            for h in self._pending:
                if h.weight_version == version and h._prefix.size > 0:
                    h.future.set_exception(RejectedError(
                        f"stream {h.rid} is pinned to retired weight "
                        f"version {version}; resubmit to run on the "
                        "restored version", reason="version_retired",
                        retry_after_s=self.config.retry_after_s))
                    self.metrics.on_reject("version_retired")
                    self._inflight.pop(h.rid, None)
                    retired += 1
                    flight_recorder().record(
                        "deploy_retire_stream", rid=h.rid,
                        version=version, emitted=int(h._prefix.size))
                else:
                    if h.weight_version == version:
                        h.weight_version = None
                    kept.append(h)
            self._pending = kept
            return retired

    # ---- the pump ----

    def pump(self) -> int:
        """One router step: supervise health, re-place failed-over and
        pending streams, pump live replicas, harvest completions.
        Returns tokens retired across the fleet this step."""
        now = self.clock.now()
        with self._lock:
            self._supervise_locked(now)
            self._place_pending_locked(now)
            live = [r for r in self.replicas
                    if not self._state[r.name].quarantined]
        # engine pumps run OUTSIDE the router lock: replicas decode
        # independently, and a slow forward on one must not block
        # admissions or another replica's harvest
        n = 0
        for r in live:
            n += r.pump()
        with self._lock:
            self._handoff_locked(self.clock.now())
            self._harvest_locked(self.clock.now())
            self._update_gauges_locked()
        return n

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._inflight) or bool(self._pending)

    def healthz(self) -> dict:
        """Fleet health summary (`RouterServer` serves this verbatim)."""
        with self._lock:
            states = {}
            for r in self.replicas:
                st = self._state[r.name]
                states[r.name] = "quarantined" if st.quarantined \
                    else r.health()
            down = sum(1 for s in states.values() if s != "ok")
            status = ("unavailable" if down == len(self.replicas)
                      else "degraded" if down else "ok")
            out = {"status": status, "replicas": states,
                   "quarantined": sorted(
                       n for n, st in self._state.items()
                       if st.quarantined),
                   "weight_versions": {
                       r.name: r.weight_version for r in self.replicas}}
            # roles only when the fleet is specialized (all-mixed is the
            # default topology); speculative decoding's per-replica window
            # accept rate (None: crashed, or no windows yet) only when some
            # replica carries a draft
            if any(r.role != "mixed" for r in self.replicas):
                out["roles"] = {r.name: r.role for r in self.replicas}
            if any(getattr(r.engine, "draft_model", None) is not None
                   for r in self.replicas):
                out["spec_accept_rates"] = {
                    r.name: (None if r.crashed else
                             r.engine.metrics.snapshot()
                             .get("spec_accept_rate"))
                    for r in self.replicas}
            return out

    # ---- lifecycle (live mode) ----

    def start(self) -> "ReplicaRouter":
        if isinstance(self.clock, SimClock):
            raise RuntimeError(
                "ReplicaRouter.start() requires a real clock; under "
                "SimClock the harness drives pump() itself")
        for r in self.replicas:
            if getattr(r.engine, "_thread", None) is None:
                r.engine.start()
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._supervise_main, name="pdtt-router", daemon=True)
        self._thread.start()
        return self

    def _supervise_main(self):
        while not self._stop_event.is_set():
            try:
                self.pump()
            except Exception:
                _log.exception("router: pump failed")
            self._stop_event.wait(self.config.poll_interval_s)

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the fleet: drain every live replica (finishing admitted
        streams), run a final harvest, and fail anything still awaiting
        placement — explicitly, never silently."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        if self._thread is not None:
            self._stop_event.set()
            self._thread.join(timeout=30.0)
            self._thread = None
        for r in self.replicas:
            if not r.crashed:
                try:
                    r.engine.stop(drain=drain, timeout=timeout)
                except Exception:
                    _log.exception("router: stopping %s failed", r.name)
        with self._lock:
            self._harvest_locked(self.clock.now())
            leftovers = list(self._pending)
            self._pending = []
            for h in leftovers:
                self._inflight.pop(h.rid, None)
            for rid, h in list(self._inflight.items()):
                h._absorb_inner()
                if h._finished():
                    h.future.set_result(h._prefix.copy())
                    self.metrics.on_complete()
                else:
                    leftovers.append(h)
                del self._inflight[rid]
            for h in leftovers:
                if not h.future.done():
                    h.future.set_exception(RejectedError(
                        f"router stopped before {h.rid} could be resumed",
                        reason="draining"))
                    self.metrics.on_fail()
            self._update_gauges_locked()


# ---------------------------------------------------------------------------
# HTTP front end


# the engine's retryable set plus the router's own back-off-and-retry words
_ROUTER_RETRYABLE = frozenset({"queue_full", "token_budget", "shed",
                               "tenant_quota", "fleet_unavailable",
                               "replica_down", "version_retired"})


class RouterServer:
    """HTTP face of the fleet: the same /generate contract as
    ServingServer (429 + Retry-After on retryable rejects, 503 on
    terminal ones, 504 on deadline), fleet-level /healthz, and
    pdtpu_router_* metrics (per-replica health, quarantines, failovers,
    prefix-affinity hit rate) on /metrics."""

    def __init__(self, router: ReplicaRouter, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 60.0):
        self.router = router
        self.request_timeout_s = float(request_timeout_s)
        self._deploy_controller = None   # built on first POST /deploy
        self._deploy_lock = threading.Lock()
        outer = self

        class _Handler(JsonHandler):
            def do_GET(self):
                if self.path == "/healthz":
                    health = outer.router.healthz()
                    code = 503 if health["status"] == "unavailable" else 200
                    self._reply_json(code, health)
                elif self.path == "/metrics":
                    text = outer.router.metrics.render()
                    ctrl = outer._deploy_controller
                    if ctrl is not None:
                        # pdtpu_deploy_* families ride the same scrape
                        text += ctrl.metrics.render()
                    self._reply(200, text.encode(),
                                ctype="text/plain; version=0.0.4")
                elif self.path == "/debug/flightrecorder":
                    self._reply_json(200, flight_recorder().snapshot())
                elif self.path == "/debug/deploy":
                    ctrl = outer._deploy_controller
                    self._reply_json(
                        200, ctrl.status() if ctrl is not None
                        else {"state": "idle", "history": []})
                else:
                    self._reply_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/deploy":
                    self._deploy()
                    return
                if self.path != "/generate":
                    self._reply_json(404, {"error": "not found"})
                    return
                body = read_request_body(self)
                if body is None:
                    return
                try:
                    payload = json.loads(body or b"{}")
                    prompt, slo, tenant, sampling, want_lp = parse_generate(
                        payload, self.headers.get("X-Tenant-Id"))
                except (ValueError, KeyError, TypeError) as e:
                    self._reply_json(400, {"error": f"bad request: {e}"})
                    return
                rid = self._request_rid()
                try:
                    handle = outer.router.submit(
                        prompt,
                        max_new_tokens=payload.get("max_new_tokens"),
                        eos_token_id=payload.get("eos_token_id"),
                        deadline_ms=payload.get("deadline_ms"),
                        slo=slo, tenant=tenant, rid=rid,
                        sampling=sampling, logprobs=want_lp)
                    toks = handle.result(timeout=outer.request_timeout_s)
                except RejectedError as e:
                    self._reply_rejected(e, _ROUTER_RETRYABLE)
                    return
                except DeadlineExceededError as e:
                    self._reply_json(504, {"error": str(e)})
                    return
                except Exception as e:  # model/decode failure
                    self._reply_json(
                        500, {"error": f"{type(e).__name__}: {e}"})
                    return
                resp = {
                    "tokens": np.asarray(toks).tolist(),
                    "ttft_ms": handle.ttft_ms,
                    "rid": rid,
                    "failovers": handle.failovers,
                }
                if want_lp:
                    resp["logprobs"] = handle.logprobs_so_far()
                self._reply_json(200, resp)

            def _deploy(self):
                """POST /deploy {"directory", "version", "wait"?}: start
                (or, with wait=true, run to completion) a rolling deploy
                of the certified weight set. 412 on uncertified weights,
                409 when a rollout is already in progress."""
                body = read_request_body(self)
                if body is None:
                    return
                from ..checkpoint import UncertifiedWeightsError, WeightSet
                try:
                    payload = json.loads(body or b"{}")
                    ws = WeightSet(payload["directory"],
                                   payload["version"])
                    wait = bool(payload.get("wait", False))
                except (ValueError, KeyError, TypeError) as e:
                    self._reply_json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    status = outer.deploy(ws, wait=wait)
                except UncertifiedWeightsError as e:
                    self._reply_json(412, {
                        "error": str(e),
                        "reason": getattr(e, "reason", "uncertified")})
                    return
                except RuntimeError as e:   # rollout already in progress
                    self._reply_json(409, {"error": str(e)})
                    return
                self._reply_json(
                    202 if status.get("state") in ("rolling",
                                                   "rolling_back")
                    else 200, status)

        _Handler.timeout = self.request_timeout_s + 30.0
        self._server = HTTPServer((host, port), _Handler)
        self._server.daemon_threads = False
        self._server.block_on_close = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def deploy(self, weightset, config=None, wait: bool = False) -> dict:
        """Roll `weightset` across the fleet. wait=False starts the
        rollout on the controller's background thread and returns the
        initial status; wait=True blocks until the rollout completes or
        rolls back and returns the final record. One controller instance
        is kept for the server's lifetime so /debug/deploy keeps
        history."""
        with self._deploy_lock:
            if self._deploy_controller is None:
                from .deploy import DeploymentController
                self._deploy_controller = DeploymentController(
                    self.router, config=config)
            ctrl = self._deploy_controller
        if wait:
            return ctrl.run(weightset)
        ctrl.spawn(weightset)
        return ctrl.status()

    def start(self) -> "RouterServer":
        self.router.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="pdtt-router-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        """Foreground serve (subprocess fixtures): SIGTERM drains the
        fleet, finishes every admitted stream, and exits 0."""
        import signal

        def _sigterm(signum, frame):
            threading.Thread(target=self.stop, daemon=True).start()

        signal.signal(signal.SIGTERM, _sigterm)
        signal.signal(signal.SIGINT, _sigterm)
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()

    def stop(self, drain: bool = True):
        self.router.stop(drain=drain)
        self._server.shutdown()
        if self._thread is not None:
            self._server.server_close()
            self._thread.join(timeout=30.0)
            self._thread = None
