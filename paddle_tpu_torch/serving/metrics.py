"""Serving metrics (counterpart of paddle_tpu/serving/metrics.py):
request counters, latency quantiles, the batch-size histogram and the
queue-depth gauge, collected by the engines on every admission and
dispatch, with the supervision counters (dispatch failures by kind, the
circuit-breaker gauge).

`ServingMetrics` is the `BatchingEngine`'s, with `render()` for a
Prometheus `/metrics` endpoint and a `serving/dispatch` profiler instant
per dispatch. `LLMMetrics` extends it for the LLM engine: TTFT (overall
and per SLO class) and inter-token latency, decode steps and tokens,
slot occupancy (instant and time-weighted), KV fragmentation, the
sampling modes, the prefix cache and tenants, the host KV tier, and the
overload-control counters (shed, quarantined, brownout, in-flight
tokens); its `render()` gives the JAX package's `pdtpu_llm_*` families.
An engine built with `economics=True` attaches its `ServingLedger` and
`SLOBurnMonitor` (`ledger`, `burn`), read at snapshot and render time
only: phase seconds, token efficiency, decode MFU, per-tenant and
per-class device seconds and the burn rates. An engine built with a
`draft_model` counts each verified window (`on_spec_window`: windows,
drafted and accepted tokens) and each quarantined draft
(`on_draft_quarantine`); without one they read 0, as the JAX families
do when unused. An engine armed with an adapter bank
counts each emitted token under its adapter id ("base" for row-0
streams) and its swaps and rollbacks.
`RouterMetrics` is the fleet router's: routing decisions per replica,
prefix-affinity hit rate, replica health, quarantines, failovers and
resumed streams, weight versions, roles and prefill-to-decode handoffs,
rendered as the JAX package's `pdtpu_router_*` families.
Snapshot keys are the JAX classes'.

Totals are lifetime counters, so a drain snapshot reconciles against a
replayed trace: submitted == completed + rejected + expired + failed.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from ..obs.prom import PromBuilder, parse_exposition  # noqa: F401

# cumulative histogram upper bounds for dispatched batch rows
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# admission priority order: interactive before batch before best_effort;
# load shedding walks the same list from the bottom up
SLO_CLASSES = ("interactive", "batch", "best_effort")


def _quantile(sorted_vals, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ServingMetrics:
    # metric family prefix: LLMMetrics overrides it so two engines behind
    # one server scrape without name collisions
    _PREFIX = "pdtpu_serving"

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.window = int(window)
        self._latencies_ms: deque = deque(maxlen=self.window)
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected": 0,
            "expired": 0, "failed": 0, "dispatches": 0,
        }
        self.reject_reasons: Dict[str, int] = {}
        self.batch_hist: Dict[int, int] = {}   # exact dispatched rows -> n
        self.queue_depth = 0
        self.dispatched_rows = 0
        self.padded_rows = 0
        # supervision: dispatch failures by kind ("raise" / "hang" /
        # "poisoned" / "engine") and the circuit-breaker gauge
        self.dispatch_failures: Dict[str, int] = {}
        self.circuit_open = False
        # economics providers, attached by an engine built with
        # economics=True and read only at snapshot/render time
        self.ledger = None   # obs.serving_ledger.ServingLedger
        self.burn = None     # obs.serving_ledger.SLOBurnMonitor

    # ---- engine callbacks ----
    def on_submit(self, queue_depth: int):
        with self._lock:
            self.counters["submitted"] += 1
            self.queue_depth = queue_depth

    def on_reject(self, reason: str):
        with self._lock:
            self.counters["rejected"] += 1
            self.reject_reasons[reason] = \
                self.reject_reasons.get(reason, 0) + 1

    def on_expire(self, n: int = 1):
        with self._lock:
            self.counters["expired"] += n

    def on_complete(self, latency_ms: float):
        with self._lock:
            self.counters["completed"] += 1
            self._latencies_ms.append(float(latency_ms))

    def on_fail(self, n: int = 1):
        with self._lock:
            self.counters["failed"] += n

    def on_dispatch(self, rows: int, n_requests: int, padded_rows: int,
                    dispatch_ms: float, queue_depth: int):
        with self._lock:
            self.counters["dispatches"] += 1
            self.batch_hist[rows] = self.batch_hist.get(rows, 0) + 1
            self.dispatched_rows += rows
            self.padded_rows += padded_rows - rows
            self.queue_depth = queue_depth
        from ..profiler import record_instant
        record_instant("serving/dispatch", {
            "rows": rows, "requests": n_requests,
            "padded_rows": padded_rows, "dispatch_ms": dispatch_ms,
            "queue_depth": queue_depth,
        })

    def set_queue_depth(self, depth: int):
        with self._lock:
            self.queue_depth = depth

    def on_dispatch_failure(self, kind: str):
        with self._lock:
            self.dispatch_failures[kind] = \
                self.dispatch_failures.get(kind, 0) + 1

    def set_circuit_open(self, open_: bool):
        with self._lock:
            self.circuit_open = bool(open_)

    # ---- views ----
    def quantile_ms(self, q: float) -> Optional[float]:
        with self._lock:
            lat = sorted(self._latencies_ms)
        return _quantile(lat, q)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            hist = dict(self.batch_hist)
            depth = self.queue_depth
            rows, padded = self.dispatched_rows, self.padded_rows
            dfail = dict(self.dispatch_failures)
            circuit = self.circuit_open
        mean_batch = rows / counters["dispatches"] if counters["dispatches"] \
            else 0.0
        return {
            **counters,
            "queue_depth": depth,
            "batch_hist": hist,
            "mean_batch_rows": mean_batch,
            "pad_overhead_rows": padded,
            "dispatch_failures": dfail,
            "circuit_open": circuit,
            "p50_ms": self.quantile_ms(0.50),
            "p95_ms": self.quantile_ms(0.95),
            "p99_ms": self.quantile_ms(0.99),
            **({"economics": self.ledger.snapshot()}
               if self.ledger is not None else {}),
            **({"slo_burn": self.burn.snapshot()}
               if self.burn is not None else {}),
        }

    def render(self) -> str:
        """Prometheus text exposition (served at /metrics)."""
        b = PromBuilder()
        self._render_into(b)
        return b.render()

    def _render_into(self, b: PromBuilder):
        s = self.snapshot()
        px = self._PREFIX
        b.family(f"{px}_requests_total", "counter")
        for outcome in ("submitted", "completed", "rejected", "expired",
                        "failed"):
            b.sample(f"{px}_requests_total", s[outcome],
                     {"outcome": outcome})
        b.family(f"{px}_dispatches_total", "counter")
        b.sample(f"{px}_dispatches_total", s["dispatches"])
        b.family(f"{px}_queue_depth", "gauge")
        b.sample(f"{px}_queue_depth", s["queue_depth"])
        b.family(f"{px}_latency_ms", "summary")
        for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
            b.sample(f"{px}_latency_ms", s[key], {"quantile": q}, round_to=3)
        b.family(f"{px}_batch_rows", "histogram")
        hist = s["batch_hist"]
        for le in BATCH_BUCKETS:
            cum = sum(n for rows, n in hist.items() if rows <= le)
            b.sample(f"{px}_batch_rows_bucket", cum, {"le": le})
        b.sample(f"{px}_batch_rows_bucket", sum(hist.values()),
                 {"le": "+Inf"})
        b.sample(f"{px}_batch_rows_count", sum(hist.values()))
        b.sample(f"{px}_batch_rows_sum",
                 sum(r * n for r, n in hist.items()))
        b.family(f"{px}_dispatch_failures_total", "counter")
        for kind in sorted(s["dispatch_failures"]):
            b.sample(f"{px}_dispatch_failures_total",
                     s["dispatch_failures"][kind], {"kind": kind})
        b.family(f"{px}_circuit_open", "gauge")
        b.sample(f"{px}_circuit_open", int(s["circuit_open"]))
        self._render_economics_into(b, s)

    def _render_economics_into(self, b: PromBuilder, s: dict):
        """Serving-economics families: phase tiling, token
        efficiency, decode MFU, per-tenant/per-class device-seconds and
        SLO burn rates — rendered only when the engine attached the
        providers, under this metrics object's own prefix (pdtpu_serving
        for the predictor engine, pdtpu_llm for the LLM engine)."""
        px = self._PREFIX
        if self.ledger is not None:
            e = s["economics"]
            b.family(f"{px}_phase_seconds_total", "counter")
            for phase, secs in sorted(e["phase_seconds"].items()):
                b.sample(f"{px}_phase_seconds_total", secs,
                         labels={"phase": phase}, round_to=4)
            b.family(f"{px}_wall_seconds", "gauge")
            b.sample(f"{px}_wall_seconds", e["wall_seconds"], round_to=4)
            b.family(f"{px}_token_efficiency", "gauge")
            b.sample(f"{px}_token_efficiency", e["token_efficiency"],
                     round_to=4)
            b.family(f"{px}_host_fraction", "gauge")
            b.sample(f"{px}_host_fraction", e["host_fraction"], round_to=4)
            b.family(f"{px}_decode_mfu", "gauge")
            b.sample(f"{px}_decode_mfu", e["decode_mfu"], round_to=6)
            if e["tenants"]:
                b.family(f"{px}_tenant_device_seconds_total", "counter")
                for tenant in sorted(e["tenants"]):
                    b.sample(f"{px}_tenant_device_seconds_total",
                             e["tenants"][tenant]["device_seconds"],
                             {"tenant": tenant}, round_to=6)
                b.family(f"{px}_tenant_device_tokens_total", "counter")
                for tenant in sorted(e["tenants"]):
                    b.sample(f"{px}_tenant_device_tokens_total",
                             e["tenants"][tenant]["tokens"],
                             {"tenant": tenant})
            if e["classes"]:
                b.family(f"{px}_class_device_seconds_total", "counter")
                for cls in sorted(e["classes"]):
                    b.sample(f"{px}_class_device_seconds_total",
                             e["classes"][cls]["device_seconds"],
                             {"slo": cls}, round_to=6)
                b.family(f"{px}_class_device_tokens_total", "counter")
                for cls in sorted(e["classes"]):
                    b.sample(f"{px}_class_device_tokens_total",
                             e["classes"][cls]["tokens"], {"slo": cls})
        if self.burn is not None:
            burn = s["slo_burn"]
            b.family(f"{px}_slo_burn_rate", "gauge")
            b.family(f"{px}_slo_burn_fired", "gauge")
            for cls in sorted(burn["classes"]):
                v = burn["classes"][cls]
                for window in ("fast", "slow"):
                    b.sample(f"{px}_slo_burn_rate", v[f"burn_{window}"],
                             {"slo": cls, "window": window}, round_to=3)
                b.sample(f"{px}_slo_burn_fired", int(v["fired"]),
                         {"slo": cls})


class LLMMetrics(ServingMetrics):
    """ServingMetrics extended for the continuous-batching LLM engine.
    The inherited batch-rows histogram counts the decode rows of each
    committed step."""

    _PREFIX = "pdtpu_llm"

    def __init__(self, window: int = 4096):
        super().__init__(window)
        self._ttft_ms: deque = deque(maxlen=self.window)
        self._intertoken_ms: deque = deque(maxlen=self.window)
        # (tokens, step_ms) pairs: tokens/sec over the recent window
        self._decode_window: deque = deque(maxlen=self.window)
        self.counters.update({
            "prefills": 0, "decode_steps": 0, "tokens_out": 0,
            "shed": 0, "quarantined": 0, "brownout_entries": 0,
            "sampled_tokens": 0, "constrained_tokens": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_hit_tokens": 0,
            "prefix_lookup_tokens": 0,
            # speculative decoding: counted by an engine with a draft
            # model; adapters: counted by an armed engine
            "spec_windows": 0, "spec_drafted": 0, "spec_accepted": 0,
            "spec_draft_quarantines": 0, "adapter_swaps": 0,
            "adapter_rollbacks": 0})
        self.class_counters: Dict[str, Dict[str, int]] = {
            c: {"submitted": 0, "completed": 0, "shed": 0}
            for c in SLO_CLASSES}
        self._class_ttft: Dict[str, deque] = {
            c: deque(maxlen=self.window) for c in SLO_CLASSES}
        # KV-pool block fragmentation: the share of allocated block tokens
        # holding no valid KV (SlotPagedKVPool.fragmentation_ratio)
        self.fragmentation = 0.0
        # time-weighted slot occupancy: the integral of occupancy over
        # time at pump granularity, so the average weighs each level by
        # how long it held
        self._occ_integral = 0.0
        self._occ_wall = 0.0
        self._occ_last_t: Optional[float] = None
        self._occ_prev = 0.0
        # emitted tokens per adapter id ("base" for row-0 streams)
        self.adapter_tokens: Dict[str, int] = {}
        self.slots_active = 0
        self.slots_total = 0
        # overload control: the brownout gauge and the estimated token
        # cost of everything queued or active
        self.brownout = False
        self.inflight_tokens = 0
        # per-slot sampling modes: slot occupancy broken down by mode, the
        # grammars compiled, and the host-side cost of assembling a step's
        # sampling operands (lane keys, per-slot params, the bank)
        self.sample_slots: Dict[str, int] = {
            "greedy": 0, "sampled": 0, "constrained": 0}
        self.grammars_compiled = 0
        self._mask_overhead_ms: deque = deque(maxlen=self.window)
        # prefix cache and tenants: aggregate cache gauges plus a breakdown
        # per tenant id (created on first sight)
        self.cached_blocks = 0
        self.cache_evictions = 0
        self.tenants: Dict[str, Dict[str, int]] = {}
        # the host KV tier's snapshot, pushed each pump; None until a
        # tiered engine reports
        self.host_kv: Optional[Dict[str, int]] = None

    def _class(self, slo) -> Optional[Dict[str, int]]:
        return self.class_counters.get(slo) if slo else None

    def _tenant(self, tenant) -> Optional[Dict[str, int]]:
        if not tenant:
            return None
        return self.tenants.setdefault(tenant, {
            "submitted": 0, "completed": 0, "rejected": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_hit_tokens": 0,
            "prefix_lookup_tokens": 0, "inflight_tokens": 0,
            "cached_blocks": 0})

    # ---- engine callbacks ----
    def on_submit(self, queue_depth: int, slo: Optional[str] = None,
                  tenant: Optional[str] = None):
        super().on_submit(queue_depth)
        with self._lock:
            c = self._class(slo)
            if c is not None:
                c["submitted"] += 1
            t = self._tenant(tenant)
            if t is not None:
                t["submitted"] += 1

    def on_reject(self, reason: str, tenant: Optional[str] = None):
        super().on_reject(reason)
        with self._lock:
            t = self._tenant(tenant)
            if t is not None:
                t["rejected"] += 1

    def on_complete(self, latency_ms: float, slo: Optional[str] = None,
                    tenant: Optional[str] = None):
        super().on_complete(latency_ms)
        with self._lock:
            c = self._class(slo)
            if c is not None:
                c["completed"] += 1
            t = self._tenant(tenant)
            if t is not None:
                t["completed"] += 1

    def on_shed(self, slo: Optional[str] = None):
        """A queued request was shed to make room for higher-priority
        work; the engine also counts it rejected (reason "shed")."""
        with self._lock:
            self.counters["shed"] += 1
            c = self._class(slo)
            if c is not None:
                c["shed"] += 1

    def on_quarantine(self):
        with self._lock:
            self.counters["quarantined"] += 1

    def set_brownout(self, active: bool):
        with self._lock:
            entered = active and not self.brownout
            self.brownout = bool(active)
            if entered:
                self.counters["brownout_entries"] += 1

    def set_inflight_tokens(self, tokens: int):
        with self._lock:
            self.inflight_tokens = int(tokens)

    # ---- speculative decoding ----
    def on_spec_window(self, drafted: int, accepted: int):
        """One verified speculative window: `drafted` tokens proposed,
        `accepted` of them kept (the corrective token is ordinary decode
        output and counts in neither)."""
        with self._lock:
            self.counters["spec_windows"] += 1
            self.counters["spec_drafted"] += int(drafted)
            self.counters["spec_accepted"] += int(accepted)

    def on_draft_quarantine(self):
        """A request's draft was quarantined after a poisoned draft
        dispatch; its target stream continues as plain decode."""
        with self._lock:
            self.counters["spec_draft_quarantines"] += 1

    # ---- multi-LoRA serving ----
    def on_adapter_token(self, adapter: str):
        """One emitted token attributed to a LoRA adapter: `adapter` is
        the bank id, or "base" for a row-0 (no-adapter) stream. The
        per-adapter counters partition the emitted tokens exactly
        (`tokens_out`, the decode steps' tokens, plus one a finished
        prefill: `prefills`), the token analogue of the ledger's adapter
        seconds partitioning the tenant device seconds."""
        with self._lock:
            self.adapter_tokens[adapter] = \
                self.adapter_tokens.get(adapter, 0) + 1

    def on_adapter_swap(self):
        with self._lock:
            self.counters["adapter_swaps"] += 1

    def on_adapter_rollback(self):
        with self._lock:
            self.counters["adapter_rollbacks"] += 1

    def set_slots(self, active: int, total: int):
        with self._lock:
            self.slots_active = int(active)
            self.slots_total = int(total)

    def observe_occupancy(self, now: float):
        """Advance the occupancy integral to `now` (once a pump pass): the
        occupancy the last observation left is credited for the elapsed
        interval, then the current gauge becomes the new level."""
        with self._lock:
            if self._occ_last_t is not None:
                dt = now - self._occ_last_t
                if dt > 0:
                    self._occ_integral += self._occ_prev * dt
                    self._occ_wall += dt
            self._occ_last_t = now
            self._occ_prev = (self.slots_active / self.slots_total
                              if self.slots_total else 0.0)

    def set_fragmentation(self, ratio: float):
        with self._lock:
            self.fragmentation = float(ratio)

    def on_prefill(self, ttft_ms: float, slo: Optional[str] = None):
        with self._lock:
            self.counters["prefills"] += 1
            self._ttft_ms.append(float(ttft_ms))
            if slo in self._class_ttft:
                self._class_ttft[slo].append(float(ttft_ms))

    def on_decode_step(self, active_rows: int, step_ms: float,
                       tokens: Optional[int] = None):
        """One committed step carrying `active_rows` decode rows that
        emitted `tokens` tokens in `step_ms`."""
        tokens = int(active_rows) if tokens is None else int(tokens)
        with self._lock:
            self.counters["decode_steps"] += 1
            self.counters["tokens_out"] += tokens
            self.batch_hist[active_rows] = \
                self.batch_hist.get(active_rows, 0) + 1
            self.dispatched_rows += int(active_rows)
            self.counters["dispatches"] += 1
            self._intertoken_ms.append(float(step_ms))
            self._decode_window.append((tokens, float(step_ms)))
        from ..profiler import record_instant
        record_instant("serving/llm_decode", {
            "active_rows": active_rows, "step_ms": step_ms,
            "tokens": tokens,
        })

    def on_sample_token(self, mode: str):
        """One emitted token from a non-greedy slot: `mode` is "sampled"
        (temperature/top-k/top-p lane) or "constrained" (grammar-masked
        lane). Greedy emissions stay in `tokens_out` alone."""
        with self._lock:
            self.counters[f"{mode}_tokens"] += 1

    def set_sample_slots(self, counts: Dict[str, int]):
        """Refresh the per-mode slot occupancy gauge from the engine's
        sampling table (greedy / sampled / constrained active slots)."""
        with self._lock:
            self.sample_slots = {
                m: int(counts.get(m, 0))
                for m in ("greedy", "sampled", "constrained")}

    def on_mask_overhead(self, ms: float):
        """Host-side sampling-operand assembly time of one sampled step."""
        with self._lock:
            self._mask_overhead_ms.append(float(ms))

    def set_grammars(self, compiled: int):
        with self._lock:
            self.grammars_compiled = int(compiled)

    def on_prefix_lookup(self, tenant: Optional[str], hit_tokens: int,
                         prompt_tokens: int):
        """One admission-time prefix-cache lookup: `hit_tokens` of
        `prompt_tokens` served from cached KV (attach + COW)."""
        with self._lock:
            hit = hit_tokens > 0
            self.counters["prefix_hits" if hit else "prefix_misses"] += 1
            self.counters["prefix_hit_tokens"] += int(hit_tokens)
            self.counters["prefix_lookup_tokens"] += int(prompt_tokens)
            t = self._tenant(tenant)
            if t is not None:
                t["prefix_hits" if hit else "prefix_misses"] += 1
                t["prefix_hit_tokens"] += int(hit_tokens)
                t["prefix_lookup_tokens"] += int(prompt_tokens)

    def set_tenant_inflight(self, per_tenant: Dict[str, int]):
        """Refresh per-tenant in-flight token gauges; tenants absent from
        the map read 0."""
        with self._lock:
            for t in self.tenants.values():
                t["inflight_tokens"] = 0
            for tenant, tokens in per_tenant.items():
                t = self._tenant(tenant)
                if t is not None:
                    t["inflight_tokens"] = int(tokens)

    def set_prefix_cache(self, cached_blocks: int, evictions: int,
                         per_tenant_cached: Optional[Dict[str, int]] = None):
        with self._lock:
            self.cached_blocks = int(cached_blocks)
            self.cache_evictions = int(evictions)
            for tenant, n in (per_tenant_cached or {}).items():
                t = self._tenant(tenant)
                if t is not None:
                    t["cached_blocks"] = int(n)

    def set_host_kv(self, snap: Dict[str, int]):
        """The host tier's `HostKVPool.snapshot()` (pages, bytes, spills,
        onboards, hits, misses, evictions, rejected)."""
        with self._lock:
            self.host_kv = dict(snap)

    # ---- views ----
    def ttft_quantile_ms(self, q: float,
                         slo: Optional[str] = None) -> Optional[float]:
        """TTFT quantile over every request, or over class `slo`'s."""
        with self._lock:
            vals = sorted(self._class_ttft[slo] if slo else self._ttft_ms)
        return _quantile(vals, q)

    def intertoken_quantile_ms(self, q: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._intertoken_ms)
        return _quantile(vals, q)

    def mask_overhead_quantile_ms(self, q: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._mask_overhead_ms)
        return _quantile(vals, q)

    def tokens_per_s(self) -> float:
        """Decode throughput: tokens emitted by decode steps per second of
        decode-step wall time (idle gaps excluded)."""
        with self._lock:
            pairs = list(self._decode_window)
        total_ms = sum(ms for _, ms in pairs)
        if total_ms <= 0:
            return 0.0
        return sum(n for n, _ in pairs) / (total_ms / 1e3)

    def snapshot(self) -> dict:
        s = super().snapshot()
        with self._lock:
            s["reject_reasons"] = dict(self.reject_reasons)
            s["classes"] = {c: dict(v)
                            for c, v in self.class_counters.items()}
            s["slots_active"] = self.slots_active
            s["slots_total"] = self.slots_total
            s["brownout"] = self.brownout
            s["inflight_tokens"] = self.inflight_tokens
            s["sample_slots"] = dict(self.sample_slots)
            s["grammars_compiled"] = self.grammars_compiled
            s["cached_blocks"] = self.cached_blocks
            s["cache_evictions"] = self.cache_evictions
            s["tenants"] = {t: dict(v) for t, v in self.tenants.items()}
            s["host_kv"] = (dict(self.host_kv)
                            if self.host_kv is not None else None)
            s["kv_fragmentation"] = self.fragmentation
            s["slot_occupancy_avg"] = (
                self._occ_integral / self._occ_wall
                if self._occ_wall > 0 else None)
            s["adapter_tokens"] = dict(self.adapter_tokens)
        for t in s["tenants"].values():
            t["cache_hit_rate"] = (
                t["prefix_hit_tokens"] / t["prefix_lookup_tokens"]
                if t["prefix_lookup_tokens"] else 0.0)
        s["prefix_hit_rate"] = (
            s["prefix_hit_tokens"] / s["prefix_lookup_tokens"]
            if s["prefix_lookup_tokens"] else 0.0)
        s["slot_occupancy"] = (s["slots_active"] / s["slots_total"]
                               if s["slots_total"] else 0.0)
        s["tokens_per_s"] = self.tokens_per_s()
        s["spec_accept_rate"] = (s["spec_accepted"] / s["spec_drafted"]
                                 if s["spec_drafted"] else None)
        s["shed_rate"] = (s["shed"] / s["submitted"] if s["submitted"]
                          else 0.0)
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            s[f"ttft_{key}_ms"] = self.ttft_quantile_ms(q)
            s[f"intertoken_{key}_ms"] = self.intertoken_quantile_ms(q)
            s[f"mask_overhead_{key}_ms"] = self.mask_overhead_quantile_ms(q)
        for c in SLO_CLASSES:
            s[f"ttft_p99_ms_{c}"] = self.ttft_quantile_ms(0.99, slo=c)
        return s

    def _render_into(self, b: PromBuilder):
        super()._render_into(b)
        s = self.snapshot()
        px = self._PREFIX
        for fam, prefix in ((f"{px}_ttft_ms", "ttft"),
                            (f"{px}_intertoken_ms", "intertoken")):
            b.family(fam, "summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                b.sample(fam, s[f"{prefix}_{key}_ms"], {"quantile": q},
                         round_to=3)
        b.family(f"{px}_tokens_per_s", "gauge")
        b.sample(f"{px}_tokens_per_s", s["tokens_per_s"], round_to=3)
        b.family(f"{px}_slots_active", "gauge")
        b.sample(f"{px}_slots_active", s["slots_active"])
        b.family(f"{px}_slots_total", "gauge")
        b.sample(f"{px}_slots_total", s["slots_total"])
        b.family(f"{px}_slot_occupancy", "gauge")
        b.sample(f"{px}_slot_occupancy", s["slot_occupancy"], round_to=4)
        b.family(f"{px}_slot_occupancy_avg", "gauge")
        b.sample(f"{px}_slot_occupancy_avg", s["slot_occupancy_avg"],
                 round_to=4)
        b.family(f"{px}_tokens_total", "counter")
        b.sample(f"{px}_tokens_total", s["tokens_out"])
        b.family(f"{px}_decode_steps_total", "counter")
        b.sample(f"{px}_decode_steps_total", s["decode_steps"])
        b.family(f"{px}_prefills_total", "counter")
        b.sample(f"{px}_prefills_total", s["prefills"])
        # ---- speculative decoding families ----
        b.family(f"{px}_spec_windows_total", "counter")
        b.sample(f"{px}_spec_windows_total", s["spec_windows"])
        b.family(f"{px}_spec_drafted_total", "counter")
        b.sample(f"{px}_spec_drafted_total", s["spec_drafted"])
        b.family(f"{px}_spec_accepted_total", "counter")
        b.sample(f"{px}_spec_accepted_total", s["spec_accepted"])
        b.family(f"{px}_spec_accept_rate", "gauge")
        b.sample(f"{px}_spec_accept_rate", s["spec_accept_rate"],
                 round_to=4)
        b.family(f"{px}_spec_draft_quarantines_total", "counter")
        b.sample(f"{px}_spec_draft_quarantines_total",
                 s["spec_draft_quarantines"])
        # ---- sampling + constrained decoding families ----
        b.family(f"{px}_sample_slots", "gauge")
        for mode in ("greedy", "sampled", "constrained"):
            b.sample(f"{px}_sample_slots", s["sample_slots"].get(mode, 0),
                     {"mode": mode})
        b.family(f"{px}_sample_tokens_total", "counter")
        for mode in ("sampled", "constrained"):
            b.sample(f"{px}_sample_tokens_total", s[f"{mode}_tokens"],
                     {"mode": mode})
        b.family(f"{px}_sample_mask_overhead_ms", "summary")
        b.sample(f"{px}_sample_mask_overhead_ms", s["mask_overhead_p99_ms"],
                 {"quantile": "0.99"}, round_to=3)
        b.family(f"{px}_sample_grammars_compiled", "gauge")
        b.sample(f"{px}_sample_grammars_compiled", s["grammars_compiled"])
        # ---- multi-LoRA serving families (none until 7b) ----
        if s["adapter_tokens"]:
            b.family(f"{px}_adapter_tokens_total", "counter")
            for aid in sorted(s["adapter_tokens"]):
                b.sample(f"{px}_adapter_tokens_total",
                         s["adapter_tokens"][aid], {"adapter": aid})
            b.family(f"{px}_adapter_swaps_total", "counter")
            b.sample(f"{px}_adapter_swaps_total", s["adapter_swaps"])
            b.family(f"{px}_adapter_rollbacks_total", "counter")
            b.sample(f"{px}_adapter_rollbacks_total",
                     s["adapter_rollbacks"])
        # ---- tiered KV cache families ----
        if s["host_kv"] is not None:
            hk = s["host_kv"]
            b.family(f"{px}_kv_host_pages_total", "gauge")
            b.sample(f"{px}_kv_host_pages_total", hk["pages"])
            b.family(f"{px}_kv_host_bytes_total", "gauge")
            b.sample(f"{px}_kv_host_bytes_total", hk["bytes"])
            b.family(f"{px}_kv_host_spills_total", "counter")
            b.sample(f"{px}_kv_host_spills_total", hk["spills"])
            b.family(f"{px}_kv_host_onboards_total", "counter")
            b.sample(f"{px}_kv_host_onboards_total", hk["onboards"])
            b.family(f"{px}_kv_host_evictions_total", "counter")
            b.sample(f"{px}_kv_host_evictions_total", hk["evictions"])
        # ---- overload control + supervision families ----
        b.family(f"{px}_class_requests_total", "counter")
        for c in SLO_CLASSES:
            for outcome in ("submitted", "completed", "shed"):
                b.sample(f"{px}_class_requests_total",
                         s["classes"][c][outcome],
                         {"slo": c, "outcome": outcome})
        b.family(f"{px}_class_ttft_ms", "summary")
        for c in SLO_CLASSES:
            b.sample(f"{px}_class_ttft_ms", s[f"ttft_p99_ms_{c}"],
                     {"slo": c, "quantile": "0.99"}, round_to=3)
        b.family(f"{px}_shed_total", "counter")
        b.sample(f"{px}_shed_total", s["shed"])
        b.family(f"{px}_quarantined_total", "counter")
        b.sample(f"{px}_quarantined_total", s["quarantined"])
        b.family(f"{px}_brownout", "gauge")
        b.sample(f"{px}_brownout", int(s["brownout"]))
        b.family(f"{px}_brownout_entries_total", "counter")
        b.sample(f"{px}_brownout_entries_total", s["brownout_entries"])
        b.family(f"{px}_inflight_tokens", "gauge")
        b.sample(f"{px}_inflight_tokens", s["inflight_tokens"])
        b.family(f"{px}_kv_fragmentation", "gauge")
        b.sample(f"{px}_kv_fragmentation", s["kv_fragmentation"], round_to=4)
        # ---- prefix cache + multi-tenancy families ----
        b.family(f"{px}_prefix_hits_total", "counter")
        b.sample(f"{px}_prefix_hits_total", s["prefix_hits"])
        b.family(f"{px}_prefix_misses_total", "counter")
        b.sample(f"{px}_prefix_misses_total", s["prefix_misses"])
        b.family(f"{px}_prefix_hit_tokens_total", "counter")
        b.sample(f"{px}_prefix_hit_tokens_total", s["prefix_hit_tokens"])
        b.family(f"{px}_prefix_hit_rate", "gauge")
        b.sample(f"{px}_prefix_hit_rate", s["prefix_hit_rate"], round_to=4)
        b.family(f"{px}_cached_blocks", "gauge")
        b.sample(f"{px}_cached_blocks", s["cached_blocks"])
        b.family(f"{px}_cache_evictions_total", "counter")
        b.sample(f"{px}_cache_evictions_total", s["cache_evictions"])
        if s["tenants"]:
            b.family(f"{px}_tenant_requests_total", "counter")
            for tenant in sorted(s["tenants"]):
                tv = s["tenants"][tenant]
                for outcome in ("submitted", "completed", "rejected"):
                    b.sample(f"{px}_tenant_requests_total", tv[outcome],
                             {"tenant": tenant, "outcome": outcome})
            for fam, key, typ, rnd in (
                    ("tenant_cache_hit_rate", "cache_hit_rate", "gauge", 4),
                    ("tenant_cached_blocks", "cached_blocks", "gauge", None),
                    ("tenant_inflight_tokens", "inflight_tokens", "gauge",
                     None)):
                b.family(f"{px}_{fam}", typ)
                for tenant in sorted(s["tenants"]):
                    b.sample(f"{px}_{fam}", s["tenants"][tenant][key],
                             {"tenant": tenant}, round_to=rnd)


class RouterMetrics:
    """Front-of-fleet router counters: routing decisions per replica,
    prefix-affinity hit rate, per-replica health and quarantine state,
    failovers with resumed-stream totals, router-level rejects, weight
    versions, roles and handoffs. Rendered under `pdtpu_router_*`, so the
    router's /metrics can carry the replicas' `pdtpu_llm_*` families
    without a name collision."""

    _PREFIX = "pdtpu_router"

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected": 0, "failed": 0,
        }
        self.reject_reasons: Dict[str, int] = {}
        self.routed: Dict[str, int] = {}           # replica -> decisions
        self.replica_state: Dict[str, str] = {}    # replica -> health word
        self.quarantines: Dict[str, int] = {}      # replica -> times down
        self.failovers: Dict[str, int] = {}        # dead replica -> events
        self.resumed_streams = 0
        self.readmissions: Dict[str, int] = {}
        self.affinity_hits = 0                     # routed to a prefix match
        self.affinity_decisions = 0
        self.replica_inflight: Dict[str, int] = {}
        self.replica_weight_version: Dict[str, str] = {}
        self.replica_role: Dict[str, str] = {}     # replica -> role tag
        self.handoffs = 0                          # prefill->decode moves
        self.handoffs_failed = 0                   # exported, but the stream
        #                                            re-prefilled instead
        self._handoff_ms: deque = deque(maxlen=4096)

    # ---- router callbacks ----
    def on_submit(self):
        with self._lock:
            self.counters["submitted"] += 1

    def on_route(self, replica: str, prefix_hit: bool):
        with self._lock:
            self.routed[replica] = self.routed.get(replica, 0) + 1
            self.affinity_decisions += 1
            if prefix_hit:
                self.affinity_hits += 1

    def on_reject(self, reason: str):
        with self._lock:
            self.counters["rejected"] += 1
            self.reject_reasons[reason] = \
                self.reject_reasons.get(reason, 0) + 1

    def on_complete(self):
        with self._lock:
            self.counters["completed"] += 1

    def on_fail(self):
        with self._lock:
            self.counters["failed"] += 1

    def set_replica(self, replica: str, state: str, inflight_tokens: int,
                    weight_version: Optional[str] = None,
                    role: Optional[str] = None):
        with self._lock:
            self.replica_state[replica] = state
            self.replica_inflight[replica] = int(inflight_tokens)
            if weight_version is not None:
                self.replica_weight_version[replica] = str(weight_version)
            if role is not None:
                self.replica_role[replica] = str(role)

    def on_handoff(self, src: str, dst: str, ms: float):
        """One completed prefill->decode handoff: KV exported from `src`,
        the stream admitted on `dst` `ms` milliseconds (router clock)
        after the export."""
        with self._lock:
            self.handoffs += 1
            self._handoff_ms.append(float(ms))

    def on_handoff_failed(self):
        """An exported stream re-prefilled instead (its staged KV went
        stale before a destination took it): never dropped."""
        with self._lock:
            self.handoffs_failed += 1

    def handoff_quantile_ms(self, q: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._handoff_ms)
        return _quantile(vals, q)

    def on_quarantine(self, replica: str):
        with self._lock:
            self.quarantines[replica] = self.quarantines.get(replica, 0) + 1

    def on_readmit(self, replica: str):
        with self._lock:
            self.readmissions[replica] = \
                self.readmissions.get(replica, 0) + 1

    def on_failover(self, replica: str, resumed: int):
        with self._lock:
            self.failovers[replica] = self.failovers.get(replica, 0) + 1
            self.resumed_streams += resumed

    # ---- views ----
    def affinity_hit_rate(self) -> float:
        with self._lock:
            if self.affinity_decisions == 0:
                return 0.0
            return self.affinity_hits / self.affinity_decisions

    def snapshot(self) -> dict:
        with self._lock:
            return {
                **self.counters,
                "reject_reasons": dict(self.reject_reasons),
                "routed": dict(self.routed),
                "replica_state": dict(self.replica_state),
                "replica_inflight": dict(self.replica_inflight),
                "quarantines": dict(self.quarantines),
                "readmissions": dict(self.readmissions),
                "failovers": dict(self.failovers),
                "replica_weight_version": dict(self.replica_weight_version),
                "replica_role": dict(self.replica_role),
                "resumed_streams": self.resumed_streams,
                "handoffs": self.handoffs,
                "handoffs_failed": self.handoffs_failed,
                "affinity_hit_rate": (
                    self.affinity_hits / self.affinity_decisions
                    if self.affinity_decisions else 0.0),
            }

    def render(self) -> str:
        b = PromBuilder()
        self._render_into(b)
        return b.render()

    def _render_into(self, b: PromBuilder):
        s = self.snapshot()
        px = self._PREFIX
        b.family(f"{px}_requests_total", "counter")
        for outcome in ("submitted", "completed", "rejected", "failed"):
            b.sample(f"{px}_requests_total", s[outcome],
                     {"outcome": outcome})
        for fam, key, typ in (("rejects_total", "reject_reasons", "counter"),
                              ("routed_total", "routed", "counter")):
            label = "reason" if key == "reject_reasons" else "replica"
            b.family(f"{px}_{fam}", typ)
            for k in sorted(s[key]):
                b.sample(f"{px}_{fam}", s[key][k], {label: k})
        b.family(f"{px}_replica_up", "gauge")
        for replica in sorted(s["replica_state"]):
            up = int(s["replica_state"][replica] == "ok")
            b.sample(f"{px}_replica_up", up, {"replica": replica})
        for fam, key, typ in (
                ("replica_inflight_tokens", "replica_inflight", "gauge"),
                ("quarantines_total", "quarantines", "counter"),
                ("readmissions_total", "readmissions", "counter"),
                ("failovers_total", "failovers", "counter")):
            b.family(f"{px}_{fam}", typ)
            for replica in sorted(s[key]):
                b.sample(f"{px}_{fam}", s[key][replica],
                         {"replica": replica})
        b.family(f"{px}_replica_weight_info", "gauge")
        for replica in sorted(s["replica_weight_version"]):
            # info-style gauge: constant 1, the version rides the label
            b.sample(f"{px}_replica_weight_info", 1,
                     {"replica": replica,
                      "version": s["replica_weight_version"][replica]})
        b.family(f"{px}_resumed_streams_total", "counter")
        b.sample(f"{px}_resumed_streams_total", s["resumed_streams"])
        b.family(f"{px}_prefix_affinity_hit_rate", "gauge")
        b.sample(f"{px}_prefix_affinity_hit_rate", s["affinity_hit_rate"],
                 round_to=4)
        if s["replica_role"]:
            b.family(f"{px}_replica_role_info", "gauge")
            for replica in sorted(s["replica_role"]):
                b.sample(f"{px}_replica_role_info", 1,
                         {"replica": replica,
                          "role": s["replica_role"][replica]})
        b.family(f"{px}_handoffs_total", "counter")
        b.sample(f"{px}_handoffs_total", s["handoffs"])
        b.family(f"{px}_handoffs_failed_total", "counter")
        b.sample(f"{px}_handoffs_failed_total", s["handoffs_failed"])
        hq = self.handoff_quantile_ms(0.99)
        if hq is not None:
            b.family(f"{px}_handoff_ms", "summary")
            b.sample(f"{px}_handoff_ms", hq, {"quantile": "0.99"},
                     round_to=3)
