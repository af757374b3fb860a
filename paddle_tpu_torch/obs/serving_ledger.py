"""Serving economics ledger (counterpart of
paddle_tpu/obs/serving_ledger.py): where did the pump's wall clock go,
who paid for it, and is the SLO error budget burning?

Built on the same frame bookkeeping as the training goodput ledger
(`obs.goodput.PhaseLedger`); the serving pump's wall clock tiles into:

- ``prefill_compute`` — the dispatch span attributed to prompt-chunk
                        positions of the unified mixed step (or the
                        whole predict dispatch in `BatchingEngine`);
- ``decode_compute``  — the dispatch span attributed to decode rows;
- ``draft_compute``   — draft-model dispatches (the draft's catch-up
                        and propose, when the engine has a draft);
- ``sample_mask``, ``kv_spill``, ``kv_onboard`` — host phases booked out
                        of the host span (sampling operands, the host KV
                        tier's spills and uploads);
- ``host``            — everything else the pump does on the CPU:
                        admission, KV-pool ops, prefix lookup, row
                        assembly, the result's readback bookkeeping;
- ``idle``            — the residual: wall minus everything booked
                        (time between pump iterations).

The engines wrap each pump pass in ``measure("host")`` and `book()` each
successful dispatch's span split between the compute phases by advanced
row positions; `book()` charges the enclosing host frame, so phase
seconds sum to wall by construction, as in training.

What "compute" means here: the JAX engine dispatches one compiled step
and blocks on its result, so its span is execution. The port launches
the step op by op from Python, so the same span, from before the step's
first launch to the host's readback of the selected tokens, also holds
the host's enqueue time. The definition is kept, so the tiling and the
per-owner sums hold as in JAX; `decode_compute` is not device-busy time.

On top of the phase tiling:

- **token economics** — every dispatch of the fixed-width unified step
  advances `useful` positions out of `num_slots * prefill_chunk` total;
  `token_efficiency = useful / total` is the pad-waste observable, and
  `decode_mfu = decode_flops_per_token * decode_tokens /
  decode_compute_seconds / peak` the effective decode utilization
  (`obs.flops`);
- **cost metering** — a dispatch's seconds are apportioned to the rows'
  tenants and SLO classes by position weights, so per-tenant device
  seconds sum to `prefill_compute + decode_compute` by construction;
- **SLOBurnMonitor** — multi-window multi-burn alerting over per-class
  request outcomes (TTFT against its target, deadline eviction, shed,
  engine failure): when the error-budget burn rate exceeds the threshold
  over both the fast and the slow window, a latched ``slo_burn``
  flight-recorder event fires and an optional bounded profiler capture
  opens.

Cost discipline: an engine built without `economics=True` pays one
predicate a hook (`if ledger is not None:`): no clock read, no
allocation, no lock. Stdlib only.
"""
from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Tuple

from .flight_recorder import flight_recorder
from .flops import decode_mfu
from .goodput import PhaseLedger

_log = logging.getLogger("paddle_tpu_torch.serving.economics")

# attribution order is the chrome-trace lane order; "sample_mask" is the
# host-side sampling-operand assembly (per-slot params, RNG-lane
# counters, DFA states, grammar bank), booked out of the enclosing host
# span so constrained-decoding overhead is visible; "kv_spill" and
# "kv_onboard" are the tiered cache's host phases: the device-to-host
# copy of pressure-evicted pages into the host pool, and the upload of
# spilled or handed-off pages at admission.
SERVING_LEDGER_PHASES = ("prefill_compute", "decode_compute",
                         "draft_compute", "sample_mask",
                         "kv_spill", "kv_onboard", "host", "idle")


class ServingLedger(PhaseLedger):
    """Phase attribution + token economics + per-owner cost metering
    over the serving pump's wall clock."""

    phases = SERVING_LEDGER_PHASES
    lane_prefix = "serving"

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        super().__init__(clock=clock)
        # token economics over the fixed-width unified step
        self.useful_positions = 0
        self.total_positions = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.dispatches = 0
        # speculative decoding: draft-side position economics (0 on an
        # engine without a draft model)
        self.draft_positions = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # decode-MFU inputs (obs.flops helpers; None until registered)
        self.flops_per_token: Optional[float] = None
        self.peak_flops_total: Optional[float] = None
        # cost metering: owner -> accumulated device seconds / tokens
        self._tenant_seconds: Dict[str, float] = {}
        self._tenant_tokens: Dict[str, int] = {}
        self._tenant_draft_tokens: Dict[str, int] = {}
        self._class_seconds: Dict[str, float] = {}
        self._class_tokens: Dict[str, int] = {}
        self._class_draft_tokens: Dict[str, int] = {}
        # multi-LoRA serving: the same per-row shares re-bucketed by
        # adapter id ("base" for row-0 streams); empty unless the engine
        # is armed with an adapter bank
        self._adapter_seconds: Dict[str, float] = {}
        self._adapter_tokens: Dict[str, int] = {}

    def set_decode_flops(self, flops_per_token: float,
                         peak_flops_total: float):
        """Register analytic decode FLOPs/token (obs.flops) and the
        device's peak so snapshot() can report effective decode MFU."""
        self.flops_per_token = float(flops_per_token)
        self.peak_flops_total = float(peak_flops_total)

    def _reset_extra_locked(self):
        self.useful_positions = 0
        self.total_positions = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.dispatches = 0
        self.draft_positions = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._tenant_seconds.clear()
        self._tenant_tokens.clear()
        self._tenant_draft_tokens.clear()
        self._class_seconds.clear()
        self._class_tokens.clear()
        self._class_draft_tokens.clear()
        self._adapter_seconds.clear()
        self._adapter_tokens.clear()

    # ---- per-dispatch attribution ----
    def book_dispatch(self, device_seconds: float, prefill_positions: int,
                      decode_positions: int, total_positions: int,
                      owners: Iterable[Tuple[str, str, int]],
                      draft_positions: int = 0, drafted: int = 0,
                      draft_accepted: int = 0,
                      adapter_owners: Optional[
                          Iterable[Tuple[str, int]]] = None):
        """Attribute ONE successful device dispatch.

        `device_seconds` is the measured span from before the step's first
        launch to the host's readback of its result (the port launches op
        by op, so the span holds the host's enqueue time as well); it is
        split between `prefill_compute`, `decode_compute` and
        `draft_compute` by advanced-position weights and — via `book()` —
        subtracted from the enclosing `host` frame,
        so the pump's tiling holds by construction. `owners` is one
        `(tenant, slo_class, positions)` triple per active row; the
        SAME device seconds are apportioned across owners by the same
        position weights, which is what makes per-tenant device seconds
        sum to `prefill_compute + decode_compute + draft_compute`
        exactly.

        Speculative decoding: draft-model dispatches book with
        `draft_positions` > 0 and zero useful positions — their seconds
        land in `draft_compute` and their per-owner positions in the
        separate `draft_tokens` meter, so per-tenant `tokens` keeps
        meaning positions the TARGET committed. A target verify dispatch
        books `drafted`/`draft_accepted` window counters, and its
        rejected window columns simply never enter `useful` — wasted
        speculation surfaces as pad-waste in `token_efficiency`, which is
        the observable the accept-rate runbook watches.

        Multi-LoRA: `adapter_owners` is one
        `(adapter_id, positions)` pair per active row — the same rows as
        `owners`, bucketed by adapter ("base" for pass-through rows) —
        so per-adapter device seconds are a re-partition of the tenant
        totals, not a second measurement.
        """
        device_seconds = max(float(device_seconds), 0.0)
        useful = int(prefill_positions) + int(decode_positions)
        draft_positions = int(draft_positions)
        advanced = useful + draft_positions
        if advanced > 0:
            pre_s = device_seconds * prefill_positions / advanced
            self.book("prefill_compute", pre_s)
            if draft_positions:
                dec_s = device_seconds * decode_positions / advanced
                self.book("decode_compute", dec_s)
                self.book("draft_compute", device_seconds - pre_s - dec_s)
            else:
                self.book("decode_compute", device_seconds - pre_s)
        else:  # a dispatch with no advanced rows is pure host overhead
            self.book("host", device_seconds)
        is_draft = draft_positions > 0
        with self._lock:
            self.dispatches += 1
            self.useful_positions += useful
            self.total_positions += int(total_positions)
            self.prefill_tokens += int(prefill_positions)
            self.decode_tokens += int(decode_positions)
            self.draft_positions += draft_positions
            self.spec_drafted += int(drafted)
            self.spec_accepted += int(draft_accepted)
            for tenant, slo, positions in owners:
                positions = int(positions)
                if positions <= 0 or advanced <= 0:
                    continue
                share = device_seconds * positions / advanced
                self._tenant_seconds[tenant] = \
                    self._tenant_seconds.get(tenant, 0.0) + share
                self._class_seconds[slo] = \
                    self._class_seconds.get(slo, 0.0) + share
                if is_draft:
                    self._tenant_draft_tokens[tenant] = \
                        self._tenant_draft_tokens.get(tenant, 0) + positions
                    self._class_draft_tokens[slo] = \
                        self._class_draft_tokens.get(slo, 0) + positions
                else:
                    self._tenant_tokens[tenant] = \
                        self._tenant_tokens.get(tenant, 0) + positions
                    self._class_tokens[slo] = \
                        self._class_tokens.get(slo, 0) + positions
            if adapter_owners is not None:
                # the SAME per-row shares re-bucketed by adapter id ("base"
                # for row-0 streams): same formula, same advanced
                # denominator, so per-adapter device seconds sum exactly to
                # the per-tenant totals of the same dispatch.
                for adapter, positions in adapter_owners:
                    positions = int(positions)
                    if positions <= 0 or advanced <= 0:
                        continue
                    share = device_seconds * positions / advanced
                    self._adapter_seconds[adapter] = \
                        self._adapter_seconds.get(adapter, 0.0) + share
                    if not is_draft:
                        self._adapter_tokens[adapter] = \
                            self._adapter_tokens.get(adapter, 0) + positions

    # ---- reporting ----
    def snapshot(self) -> dict:
        """Point-in-time economics view: wall + phase tiling (idle =
        residual), token efficiency, host fraction, effective decode MFU
        (None until flops are registered), and the per-owner meters."""
        wall, phases = self.wall_and_phases()
        with self._lock:
            useful = self.useful_positions
            total = self.total_positions
            prefill_toks = self.prefill_tokens
            decode_toks = self.decode_tokens
            dispatches = self.dispatches
            draft_pos = self.draft_positions
            drafted = self.spec_drafted
            accepted = self.spec_accepted
            tenants = {t: {"device_seconds": s,
                           "tokens": self._tenant_tokens.get(t, 0),
                           "draft_tokens":
                               self._tenant_draft_tokens.get(t, 0)}
                       for t, s in self._tenant_seconds.items()}
            classes = {c: {"device_seconds": s,
                           "tokens": self._class_tokens.get(c, 0),
                           "draft_tokens":
                               self._class_draft_tokens.get(c, 0)}
                      for c, s in self._class_seconds.items()}
            adapters = {a: {"device_seconds": s,
                            "tokens": self._adapter_tokens.get(a, 0)}
                        for a, s in self._adapter_seconds.items()}
        compute = (phases["prefill_compute"] + phases["decode_compute"]
                   + phases["draft_compute"])
        mfu = decode_mfu(self.flops_per_token, decode_toks,
                         phases["decode_compute"], self.peak_flops_total)
        return {
            "wall_seconds": wall,
            "phase_seconds": phases,
            "compute_seconds": compute,
            "host_fraction": phases["host"] / wall if wall > 0 else 0.0,
            "token_efficiency": (useful / total) if total else None,
            "useful_positions": useful,
            "total_positions": total,
            "prefill_tokens": prefill_toks,
            "decode_tokens": decode_toks,
            "dispatches": dispatches,
            "decode_mfu": mfu,
            "draft_positions": draft_pos,
            "spec_drafted": drafted,
            "spec_accepted": accepted,
            "spec_accept_rate": (accepted / drafted) if drafted else None,
            "tenants": tenants,
            "classes": classes,
            "adapters": adapters,
        }


class SLOBurnMonitor:
    """Multi-window multi-burn error-budget alerting over per-class
    request outcomes (the Prometheus/SRE recipe: alert only when BOTH a
    fast and a slow window burn the budget faster than `threshold`×).

    `observe(slo_class, good)` records one outcome event at clock-now.
    Burn rate over a window = (bad fraction) / `budget`; with
    `budget=0.05` a total outage burns at 20×, so the classic page
    threshold of 14.4× fires on sustained failure but not on a single
    blip. Windows with fewer than `min_events` outcomes never fire
    (cold-start guard). A crossing is latched per class — one
    ``slo_burn`` flight event, not a storm — and, when `capture_s` > 0,
    opens a bounded profiler capture window exported on the first
    observation past the deadline (deterministic: no timer threads, so
    SimClock tests drive it too).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 budget: float = 0.05, threshold: float = 14.4,
                 fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                 min_events: int = 10, capture_s: float = 0.0,
                 capture_path: Optional[str] = None):
        if not 0.0 < budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {budget}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if not 0.0 < fast_window_s <= slow_window_s:
            raise ValueError(
                "windows must satisfy 0 < fast <= slow, got "
                f"fast={fast_window_s} slow={slow_window_s}")
        if min_events < 1:
            raise ValueError(f"min_events must be >= 1, got {min_events}")
        self._clock = clock
        self.budget = float(budget)
        self.threshold = float(threshold)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.min_events = int(min_events)
        self.capture_s = float(capture_s)
        self.capture_path = capture_path or os.path.join(
            tempfile.gettempdir(), "pdtpu_slo_burn")
        self._lock = threading.Lock()
        self._events: Dict[str, deque] = {}   # class -> deque[(t, good)]
        self._fired: Dict[str, dict] = {}     # class -> fire record
        self._capture_until: Optional[float] = None

    def _burn(self, dq: deque, now: float, window_s: float):
        """(burn_rate, n_events) over [now - window_s, now]; burn is None
        below the min_events floor."""
        lo = now - window_s
        n = bad = 0
        for t, good in reversed(dq):
            if t < lo:
                break
            n += 1
            if not good:
                bad += 1
        if n < self.min_events:
            return None, n
        return (bad / n) / self.budget, n

    def observe(self, slo_class: str, good: bool, **info):
        """Record one per-class outcome; fires the latched `slo_burn`
        flight event when both windows cross the threshold."""
        now = self._clock()
        fire = None
        with self._lock:
            dq = self._events.get(slo_class)
            if dq is None:
                dq = self._events[slo_class] = deque()
            dq.append((now, bool(good)))
            lo = now - self.slow_window_s
            while dq and dq[0][0] < lo:
                dq.popleft()
            if slo_class not in self._fired:
                fast, n_fast = self._burn(dq, now, self.fast_window_s)
                slow, n_slow = self._burn(dq, now, self.slow_window_s)
                if (fast is not None and slow is not None
                        and fast >= self.threshold
                        and slow >= self.threshold):
                    fire = {
                        "slo": slo_class,
                        "burn_fast": round(fast, 3),
                        "burn_slow": round(slow, 3),
                        "threshold": self.threshold,
                        "budget": self.budget,
                        "fast_window_s": self.fast_window_s,
                        "slow_window_s": self.slow_window_s,
                        "events_fast": n_fast,
                        "events_slow": n_slow,
                    }
                    self._fired[slo_class] = dict(fire, t=now)
                    if self.capture_s > 0 and self._capture_until is None:
                        self._capture_until = now + self.capture_s
                        fire["capture_s"] = self.capture_s
        if fire is not None:
            flight_recorder().record("slo_burn", **fire, **info)
            _log.warning(
                "SLO burn: class %r burning its error budget at "
                "%.1fx/%.1fx (fast/slow windows, threshold %.1fx)",
                slo_class, fire["burn_fast"], fire["burn_slow"],
                self.threshold)
            if "capture_s" in fire:
                self._start_capture()
        self._maybe_finish_capture(now)

    # ---- bounded profiler capture (optional postmortem window) ----
    def _start_capture(self):
        try:
            from ..profiler import profiler_enabled, start_profiler
            if not profiler_enabled():
                start_profiler()
        except Exception:       # profiler absent/broken: alerting still works
            _log.debug("slo_burn profiler capture unavailable",
                       exc_info=True)
            with self._lock:
                self._capture_until = None

    def _maybe_finish_capture(self, now: float):
        with self._lock:
            if self._capture_until is None or now < self._capture_until:
                return
            self._capture_until = None
        try:
            from ..profiler import stop_profiler
            stop_profiler(profile_path=self.capture_path)
            flight_recorder().record("slo_burn_capture",
                                     path=self.capture_path)
        except Exception:
            _log.debug("slo_burn profiler export failed", exc_info=True)

    def snapshot(self) -> dict:
        """Per-class burn rates over both windows + latched fire records."""
        now = self._clock()
        out: Dict[str, dict] = {}
        with self._lock:
            for cls, dq in self._events.items():
                fast, n_fast = self._burn(dq, now, self.fast_window_s)
                slow, n_slow = self._burn(dq, now, self.slow_window_s)
                out[cls] = {"burn_fast": fast, "burn_slow": slow,
                            "events_fast": n_fast, "events_slow": n_slow,
                            "fired": cls in self._fired}
            return {"classes": out, "fired": dict(self._fired),
                    "threshold": self.threshold, "budget": self.budget}
