"""Training numerics observatory (counterpart of
paddle_tpu/obs/numerics.py): in-step grad/update telemetry,
culprit-named non-finite blame, and a loss-spike sentinel.

- **In-step telemetry** — per-parameter-group gradient global norms,
  parameter norms, and update ratios l2(new - old) / l2(old), computed on
  the device by an armed train step (`in_step_telemetry`, kept in the
  step's `_extras["numerics"]`) and read on the host every ``interval``
  steps, with the AMP loss scale and its good and bad counters. The
  port's optimizer updates parameters in place, so the armed step keeps
  a copy of the parameters it is about to update and reads the
  gradients before they are dropped (parallel/api.py). Disarmed, every
  hook is one ``is not None`` predicate.
- **Culprit-named blame** — when ``bad_loss`` fires, the trainer runs
  the step's blame probe on the same batch and parameters
  (``ShardedTrainStep.nonfinite_blame``: the loss differentiated again
  with `torch.autograd.grad`, no update) counting non-finite elements
  per grad and param leaf; ``observe_nonfinite`` emits a
  ``train_nonfinite`` flight event naming the worst leaf
  (``params['h'][3]['attn']['wq'].grad: 128 non-finite of 1.2e6``)
  before the rollback, and dumps the black box. The probe's wall time
  is booked as ``rollback_waste`` in the goodput ledger.
- **Loss-spike sentinel** — a rolling robust z-score (median/MAD) over
  recent finite losses fires a latched ``train_loss_spike`` flight
  event; a spike storm (>= storm_threshold) logs a grouped warning once
  and dumps the black box.

``nonfinite_count`` / ``nonfinite_total`` / ``all_finite`` are the one
implementation of the non-finite census (the loss scalers share
``all_finite``). They and ``in_step_telemetry`` act on torch tensors on
their own device and never wait for the host.

Exposition: ``pdtpu_train_numerics_*`` Prometheus families (riding
``TrainingMetrics.render``), chrome ``numerics/<family>`` counter lanes,
and ``GET /debug/numerics`` on ``MetricsServer``.

Module import stays stdlib-only; torch is imported inside the tensor
helpers.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .flight_recorder import flight_recorder

_log = logging.getLogger("paddle_tpu_torch.numerics")

# telemetry families computed by the armed step, in render order
TELEMETRY_FAMILIES = ("grad_norm", "param_norm", "update_ratio")


# ---- the shared non-finite census (the one implementation) ----

def nonfinite_count(x):
    """0-d int32 count of the non-finite elements of one tensor."""
    import torch
    return (~torch.isfinite(x)).sum(dtype=torch.int32)


def nonfinite_total(leaves):
    """0-d int32 total of the non-finite elements of an iterable of
    tensors."""
    import torch
    leaves = list(leaves)
    if not leaves:
        return torch.tensor(0, dtype=torch.int32)
    return torch.stack([nonfinite_count(g) for g in leaves]).sum(
        dtype=torch.int32)


def all_finite(tensors):
    """0-d bool tensor: every element of every tensor is finite. One
    reduction a tensor and one over their results, on the tensors' device:
    nothing waits for the host. True for an empty list."""
    import torch
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


# ---- in-step telemetry (computed by the armed step) ----

def telemetry_groups(names, depth: int = 2) -> Dict[str, List[str]]:
    """Group dotted parameter names into bounded telemetry groups: the
    first path segment, plus the layer index when the second segment is
    numeric (``h.3.attn.wq.weight`` -> ``h.3``, ``embed.weight`` ->
    ``embed``)."""
    groups: Dict[str, List[str]] = {}
    for name in sorted(names):
        segs = str(name).split(".")
        group = segs[0]
        if depth > 1 and len(segs) > 1 and segs[1].isdigit():
            group = f"{segs[0]}.{segs[1]}"
        groups.setdefault(group, []).append(name)
    return groups


def telemetry_keys(groups) -> List[str]:
    """Deterministic key order of the extras["numerics"] scalar dict:
    ``<family>/<group>`` plus the ``<family>/_total`` aggregate."""
    out = []
    for fam in TELEMETRY_FAMILIES:
        for g in sorted(groups):
            out.append(f"{fam}/{g}")
        out.append(f"{fam}/_total")
    return out


def group_index(groups, names):
    """[len(names)] int64 group index of each name, in sorted group
    order (the order `in_step_telemetry` sums in)."""
    order = {g: i for i, g in enumerate(sorted(groups))}
    of = {n: order[g] for g, ns in groups.items() for n in ns}
    return [of[n] for n in names]


def in_step_telemetry(groups, gsq, psq, wsq, dsq):
    """Per-group gradient global norms, parameter norms and update
    ratios l2(new - old) / l2(old) as a flat dict of 0-d fp32 tensors
    (keys from ``telemetry_keys``), from the per-group fp32 sums of
    squares of the gradients (`gsq`), the new parameters (`psq`), the old
    ones (`wsq`) and their difference (`dsq`), each a [G] tensor in sorted
    group order."""
    import torch
    eps = torch.tensor(1e-12, dtype=torch.float32, device=gsq.device)
    fams = {"grad_norm": gsq.sqrt(), "param_norm": psq.sqrt(),
            "update_ratio": dsq.sqrt() / torch.maximum(wsq.sqrt(), eps)}
    totals = {"grad_norm": gsq.sum().sqrt(),
              "param_norm": psq.sum().sqrt(),
              "update_ratio": dsq.sum().sqrt() / torch.maximum(
                  wsq.sum().sqrt(), eps)}
    out = {}
    for fam in TELEMETRY_FAMILIES:
        for i, g in enumerate(sorted(groups)):
            out[f"{fam}/{g}"] = fams[fam][i]
        out[f"{fam}/_total"] = totals[fam]
    return out


# ---- culprit formatting ----

def bracket_path(name: str, root: str = "params") -> str:
    """``h.3.attn.wq.weight`` -> ``params['h'][3]['attn']['wq']['weight']``
    — the leaf-path spelling the compile observatory's culprit diffs
    established (integers index, strings key)."""
    parts = []
    for seg in str(name).split("."):
        parts.append(f"[{seg}]" if seg.isdigit() else f"[{seg!r}]")
    return root + "".join(parts)


def _human_count(n) -> str:
    """``1234567`` -> ``1.2e6`` (the culprit spelling); small counts stay
    exact."""
    n = int(n)
    if n < 100000:
        return str(n)
    mant, exp = f"{n:.1e}".split("e")
    return f"{mant}e{int(exp)}"


def format_leaf(name: str, kind: str, count: int,
                size: Optional[int] = None) -> str:
    """One culprit line: ``params['h'][3]['attn']['wq'].grad: 128
    non-finite of 1.2e6``. ``kind`` is ``grad`` or ``param``."""
    # grads share the param tree's paths; the .grad/.param suffix names
    # which side of the census the count came from
    s = f"{bracket_path(name)}.{kind}: {int(count)} non-finite"
    if size:
        s += f" of {_human_count(size)}"
    return s


# ---- the observatory ----

class NumericsObservatory:
    """Host-side accumulator for the three instruments. One instance per
    trainer (``ResilientTrainer(numerics=True)``); construction also
    registers it as the process-current observatory so ``GET
    /debug/numerics`` and the module-level renderers see it. Every hook
    in the hot path is ``if self.numerics is not None:``: one predicate,
    no clock read, when disarmed."""

    def __init__(self, interval: int = 10, spike_window: int = 32,
                 spike_zscore: float = 6.0, spike_min_points: int = 8,
                 storm_threshold: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if spike_min_points < 3:
            raise ValueError(
                f"spike_min_points must be >= 3, got {spike_min_points}")
        self.interval = int(interval)
        self.spike_zscore = float(spike_zscore)
        self.spike_min_points = int(spike_min_points)
        self.storm_threshold = int(storm_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        self._losses: deque = deque(maxlen=int(spike_window))
        self.last_sample: Dict[str, float] = {}
        self.last_sample_step = 0
        self.samples = 0
        self._history: deque = deque(maxlen=64)
        self.loss_spikes = 0
        self._storm_warned = False
        self.last_zscore: Optional[float] = None
        self.nonfinite_events = 0
        self.nonfinite_by_culprit: Dict[str, int] = {}
        set_current(self)

    # ---- in-step telemetry sampling ----
    def should_sample(self, step: int, n: int = 1) -> bool:
        """True when [step-n, step) crosses an interval boundary — the
        same first-boundary-at-or-past rule the checkpoint cadence uses,
        so chunked (n=K) and eager (n=1) runs sample at the same rate."""
        return (int(step) // self.interval) > ((int(step) - int(n))
                                               // self.interval)

    def observe_sample(self, step: int, sample: Dict[str, float]):
        """Record one host-side telemetry sample (the small scalar dict
        the armed step computed on device). Emits chrome counter lanes
        when the profiler is running."""
        clean = {k: float(v) for k, v in sample.items()}
        with self._lock:
            self.last_sample = clean
            self.last_sample_step = int(step)
            self.samples += 1
            self._history.append({"step": int(step), **clean})
        self._emit_chrome_counters(clean)

    def _emit_chrome_counters(self, sample: Dict[str, float]):
        """numerics/<family> chrome counter series ("C" events), one per
        telemetry family, args keyed by group — no-op (after the cached
        import) unless the profiler is running."""
        try:
            from ..profiler import emit_events, profiler_enabled
        except Exception:
            return
        if not profiler_enabled():
            return
        ts = time.perf_counter_ns() / 1e3
        by_family: Dict[str, dict] = {}
        for key, val in sample.items():
            fam, _, group = key.partition("/")
            by_family.setdefault(fam, {})[group or "value"] = round(val, 6)
        emit_events([
            {"name": f"numerics/{fam}", "ph": "C", "pid": 0, "tid": 0,
             "ts": ts, "args": args}
            for fam, args in sorted(by_family.items())])

    # ---- loss-spike sentinel ----
    def observe_loss(self, step: int, value: float) -> Optional[float]:
        """Feed one finite per-step loss; returns the robust z-score
        against the rolling window (None while warming up / non-finite
        input). |z| >= spike_zscore fires a ``train_loss_spike`` flight
        event; the storm latch warns once and dumps the black box."""
        import math
        v = float(value)
        if not math.isfinite(v):
            return None  # the bad_loss path owns non-finite losses
        with self._lock:
            window = list(self._losses)
            self._losses.append(v)
        if len(window) < self.spike_min_points:
            return None
        med = _median(window)
        mad = _median([abs(x - med) for x in window])
        if mad <= 0.0:
            # a flat window: fall back to a tiny scale so a genuine jump
            # still registers while bit-identical losses never fire
            mad = max(abs(med) * 1e-6, 1e-12)
        z = 0.6745 * (v - med) / mad
        with self._lock:
            self.last_zscore = z
        if abs(z) < self.spike_zscore:
            return z
        with self._lock:
            self.loss_spikes += 1
            spikes = self.loss_spikes
            storm = (spikes >= self.storm_threshold
                     and not self._storm_warned)
            if storm:
                self._storm_warned = True
        flight_recorder().record(
            "train_loss_spike", step=int(step), value=round(v, 6),
            zscore=round(z, 2), median=round(med, 6), window=len(window),
            storm=storm)
        self._record_instant("train_loss_spike",
                             {"step": int(step), "zscore": round(z, 2)})
        if storm:
            _log.warning(
                "loss-spike storm: %d spikes of |z| >= %.1f within one run "
                "(latest: step %d, loss %.6g, z=%.1f) — check the "
                "numerics lanes for a grad-norm ramp before this step; "
                "dumping the black box", spikes, self.spike_zscore,
                int(step), v, z)
            flight_recorder().try_dump(reason="loss_spike_storm")
        return z

    # ---- culprit-named non-finite blame ----
    def observe_nonfinite(self, step: int, report: Dict) -> str:
        """Digest one blame-probe report (``{"loss": float, "sizes":
        {name: numel}, "grads": {name: count>0}, "params": {...}}``) into
        a culprit-named ``train_nonfinite`` flight event + black-box
        dump. Returns the culprit line. The caller (ResilientTrainer)
        invokes this BEFORE rolling back, so the dump holds the evidence
        the rollback is about to destroy."""
        sizes = report.get("sizes", {})
        entries: List[Tuple[int, int, str, str]] = []
        for kind_rank, (kind, counts) in enumerate(
                (("grad", report.get("grads", {})),
                 ("param", report.get("params", {})))):
            for name, cnt in counts.items():
                entries.append((int(cnt), kind_rank, str(name), kind))
        # worst count first; grads break ties (a bad grad with clean
        # params names the step that poisoned it, not the victim)
        entries.sort(key=lambda e: (-e[0], e[1], e[2]))
        if entries:
            cnt, _, name, kind = entries[0]
            culprit = format_leaf(name, kind, cnt, sizes.get(name))
            leaf_key = culprit.split(": ")[0]
        else:
            culprit = ("no non-finite grad/param leaves (loss corrupted "
                       "downstream of the gradients)")
            leaf_key = "(none)"
        top = "; ".join(
            format_leaf(n, k, c, sizes.get(n)) for c, _, n, k in entries[:4])
        with self._lock:
            self.nonfinite_events += 1
            self.nonfinite_by_culprit[leaf_key] = \
                self.nonfinite_by_culprit.get(leaf_key, 0) + 1
        loss = report.get("loss")
        flight_recorder().record(
            "train_nonfinite", step=int(step), culprit=culprit,
            leaves=top,
            grad_leaves=len(report.get("grads", {})),
            param_leaves=len(report.get("params", {})),
            grad_nonfinite=sum(int(c) for c in
                               report.get("grads", {}).values()),
            param_nonfinite=sum(int(c) for c in
                                report.get("params", {}).values()),
            loss=str(loss) if loss is not None else None,
            probe_seconds=report.get("probe_seconds"))
        self._record_instant("train_nonfinite",
                             {"step": int(step), "culprit": culprit})
        _log.warning("non-finite loss at step %d blamed on %s",
                     int(step), culprit)
        flight_recorder().try_dump(reason="train_nonfinite")
        return culprit

    @staticmethod
    def _record_instant(kind: str, args: dict):
        try:
            from ..profiler import record_instant
        except Exception:
            return
        record_instant(f"numerics/{kind}", args=args)

    # ---- reporting ----
    def snapshot(self) -> dict:
        """The /debug/numerics payload."""
        with self._lock:
            return {
                "interval": self.interval,
                "samples": self.samples,
                "last_sample_step": self.last_sample_step,
                "last_sample": dict(self.last_sample),
                "loss_window": len(self._losses),
                "loss_spikes": self.loss_spikes,
                "last_zscore": self.last_zscore,
                "nonfinite_events": self.nonfinite_events,
                "nonfinite_by_culprit": dict(self.nonfinite_by_culprit),
                "history": list(self._history),
            }

    def render_prom(self) -> str:
        """``pdtpu_train_numerics_*`` families; "" until the first sample
        or event, so scrapes of disarmed processes stay byte-identical."""
        snap = self.snapshot()
        if not snap["samples"] and not snap["loss_spikes"] \
                and not snap["nonfinite_events"]:
            return ""
        from .prom import PromBuilder
        b = PromBuilder()
        px = "pdtpu_train_numerics"
        sample = snap["last_sample"]
        for fam in TELEMETRY_FAMILIES:
            keys = sorted(k for k in sample if k.startswith(fam + "/"))
            if not keys:
                continue
            b.family(f"{px}_{fam}", "gauge")
            for key in keys:
                group = key.split("/", 1)[1]
                b.sample(f"{px}_{fam}", sample[key],
                         labels={"group": group}, round_to=6)
        for scalar in ("loss_scale", "good_steps", "bad_steps"):
            if scalar in sample:
                b.family(f"{px}_{scalar}", "gauge")
                b.sample(f"{px}_{scalar}", sample[scalar], round_to=6)
        b.family(f"{px}_sample_step", "gauge")
        b.sample(f"{px}_sample_step", snap["last_sample_step"])
        b.family(f"{px}_loss_spikes_total", "counter")
        b.sample(f"{px}_loss_spikes_total", snap["loss_spikes"])
        b.family(f"{px}_nonfinite_events_total", "counter")
        b.sample(f"{px}_nonfinite_events_total", snap["nonfinite_events"])
        if snap["nonfinite_by_culprit"]:
            b.family(f"{px}_nonfinite_by_culprit_total", "counter")
            for leaf in sorted(snap["nonfinite_by_culprit"]):
                b.sample(f"{px}_nonfinite_by_culprit_total",
                         snap["nonfinite_by_culprit"][leaf],
                         labels={"culprit": leaf})
        return b.render()


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


# ---- process-current observatory (for /debug/numerics + module render) --

_CURRENT_LOCK = threading.Lock()
_CURRENT: Optional[NumericsObservatory] = None


def set_current(obs: Optional[NumericsObservatory]):
    """Register the process-current observatory (latest constructed wins;
    None clears). The HTTP debug route and module renderers read it."""
    global _CURRENT
    with _CURRENT_LOCK:
        _CURRENT = obs


def current_numerics() -> Optional[NumericsObservatory]:
    with _CURRENT_LOCK:
        return _CURRENT


def debug_snapshot() -> dict:
    """GET /debug/numerics payload: the current observatory's snapshot,
    or ``{"armed": false}`` when no trainer armed one."""
    obs = current_numerics()
    if obs is None:
        return {"armed": False}
    return {"armed": True, **obs.snapshot()}


def render_prom() -> str:
    """Scrape-time helper: the current observatory's exposition, or ""
    — scrapes stay byte-identical for processes that never armed it."""
    obs = current_numerics()
    return obs.render_prom() if obs is not None else ""
