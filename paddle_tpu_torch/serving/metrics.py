"""LLM serving metrics (counterpart of paddle_tpu/serving/metrics.py).

Only the `LLMMetrics` callbacks the ported engine calls: request outcomes,
queue depth, slot occupancy, TTFT, decode steps and tokens, the sampling
modes (slots and tokens per mode, compiled grammars, the host cost of a
step's sampling operands), the prefix cache (lookups, hit tokens, cached
blocks, evictions), per-tenant counters and in-flight tokens, the host
KV tier's snapshot, and `snapshot()`, whose keys are the JAX class's.
Prometheus exposition and the economics providers wait for the serving
front-end slice.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

# admission priority order: interactive before batch before best_effort
SLO_CLASSES = ("interactive", "batch", "best_effort")


def _quantile(sorted_vals, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class LLMMetrics:
    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.window = int(window)
        self._latencies_ms: deque = deque(maxlen=self.window)
        self._ttft_ms: deque = deque(maxlen=self.window)
        self._intertoken_ms: deque = deque(maxlen=self.window)
        # (tokens, step_ms) pairs: tokens/sec over the recent window
        self._decode_window: deque = deque(maxlen=self.window)
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected": 0, "expired": 0,
            "failed": 0, "prefills": 0, "decode_steps": 0, "tokens_out": 0,
            "sampled_tokens": 0, "constrained_tokens": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_hit_tokens": 0,
            "prefix_lookup_tokens": 0}
        self.reject_reasons: Dict[str, int] = {}
        self.class_counters: Dict[str, Dict[str, int]] = {
            c: {"submitted": 0, "completed": 0} for c in SLO_CLASSES}
        self.batch_hist: Dict[int, int] = {}   # decode rows per step -> n
        self.queue_depth = 0
        self.slots_active = 0
        self.slots_total = 0
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
        with self._lock:
            self.counters["submitted"] += 1
            self.queue_depth = queue_depth
            if slo in self.class_counters:
                self.class_counters[slo]["submitted"] += 1
            t = self._tenant(tenant)
            if t is not None:
                t["submitted"] += 1

    def on_reject(self, reason: str, tenant: Optional[str] = None):
        with self._lock:
            self.counters["rejected"] += 1
            self.reject_reasons[reason] = \
                self.reject_reasons.get(reason, 0) + 1
            t = self._tenant(tenant)
            if t is not None:
                t["rejected"] += 1

    def on_expire(self, n: int = 1):
        with self._lock:
            self.counters["expired"] += n

    def on_complete(self, latency_ms: float, slo: Optional[str] = None,
                    tenant: Optional[str] = None):
        with self._lock:
            self.counters["completed"] += 1
            self._latencies_ms.append(float(latency_ms))
            if slo in self.class_counters:
                self.class_counters[slo]["completed"] += 1
            t = self._tenant(tenant)
            if t is not None:
                t["completed"] += 1

    def on_fail(self, n: int = 1):
        with self._lock:
            self.counters["failed"] += n

    def set_queue_depth(self, depth: int):
        with self._lock:
            self.queue_depth = depth

    def set_slots(self, active: int, total: int):
        with self._lock:
            self.slots_active = int(active)
            self.slots_total = int(total)

    def on_prefill(self, ttft_ms: float, slo: Optional[str] = None):
        with self._lock:
            self.counters["prefills"] += 1
            self._ttft_ms.append(float(ttft_ms))

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
            self._intertoken_ms.append(float(step_ms))
            self._decode_window.append((tokens, float(step_ms)))

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
    def ttft_quantile_ms(self, q: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._ttft_ms)
        return _quantile(vals, q)

    def latency_quantile_ms(self, q: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._latencies_ms)
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
        with self._lock:
            s = dict(self.counters)
            s["reject_reasons"] = dict(self.reject_reasons)
            s["classes"] = {c: dict(v)
                            for c, v in self.class_counters.items()}
            s["batch_hist"] = dict(self.batch_hist)
            s["queue_depth"] = self.queue_depth
            s["slots_active"] = self.slots_active
            s["slots_total"] = self.slots_total
            s["sample_slots"] = dict(self.sample_slots)
            s["grammars_compiled"] = self.grammars_compiled
            s["cached_blocks"] = self.cached_blocks
            s["cache_evictions"] = self.cache_evictions
            s["tenants"] = {t: dict(v) for t, v in self.tenants.items()}
            s["host_kv"] = (dict(self.host_kv)
                            if self.host_kv is not None else None)
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
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            s[f"ttft_{key}_ms"] = self.ttft_quantile_ms(q)
            s[f"intertoken_{key}_ms"] = self.intertoken_quantile_ms(q)
            s[f"{key}_ms"] = self.latency_quantile_ms(q)
            s[f"mask_overhead_{key}_ms"] = self.mask_overhead_quantile_ms(q)
        return s
