"""Rolling-deployment metrics (counterpart of
paddle_tpu/obs/deploy_metrics.py): the `pdtpu_deploy_*` families.

One `DeployMetrics` instance rides a `DeploymentController` for its
lifetime and renders alongside the router's `pdtpu_router_*` families on
the same /metrics scrape. Counters are monotone across rollouts (a
fleet's deploy history is a lifetime series, not a per-rollout one);
`in_progress` is the only stateful gauge.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .prom import PromBuilder


class DeployMetrics:
    """pdtpu_deploy_* counters/gauges for the rolling-deploy controller:
    deploys by outcome (started / completed / rolled_back), per-replica
    swaps, canary verdicts, rollbacks by trigger reason, streams retired
    by a version rollback, and the in-progress / last-duration gauges."""

    _PREFIX = "pdtpu_deploy"

    def __init__(self):
        self._lock = threading.Lock()
        self.deploys: Dict[str, int] = {
            "started": 0, "completed": 0, "rolled_back": 0}
        self.swaps = 0
        self.canaries: Dict[str, int] = {"pass": 0, "fail": 0}
        self.rollback_reasons: Dict[str, int] = {}
        self.retired_streams = 0
        self.in_progress = 0
        self.last_duration_s: Optional[float] = None
        self.current_version: Optional[str] = None

    # ---- controller callbacks ----
    def on_start(self, version: str):
        with self._lock:
            self.deploys["started"] += 1
            self.in_progress = 1
            self.current_version = version

    def on_swap(self):
        with self._lock:
            self.swaps += 1

    def on_canary(self, passed: bool):
        with self._lock:
            self.canaries["pass" if passed else "fail"] += 1

    def on_rollback(self, reason: str):
        with self._lock:
            self.rollback_reasons[reason] = \
                self.rollback_reasons.get(reason, 0) + 1

    def on_retired(self, n: int):
        with self._lock:
            self.retired_streams += int(n)

    def on_finish(self, outcome: str, duration_s: float):
        """outcome: "completed" | "rolled_back"."""
        with self._lock:
            self.deploys[outcome] = self.deploys.get(outcome, 0) + 1
            self.in_progress = 0
            self.last_duration_s = float(duration_s)

    # ---- views ----
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "deploys": dict(self.deploys),
                "swaps": self.swaps,
                "canaries": dict(self.canaries),
                "rollback_reasons": dict(self.rollback_reasons),
                "retired_streams": self.retired_streams,
                "in_progress": self.in_progress,
                "last_duration_s": self.last_duration_s,
                "current_version": self.current_version,
            }

    def render(self) -> str:
        b = PromBuilder()
        self._render_into(b)
        return b.render()

    def _render_into(self, b: PromBuilder):
        s = self.snapshot()
        px = self._PREFIX
        b.family(f"{px}_deploys_total", "counter")
        for outcome in sorted(s["deploys"]):
            b.sample(f"{px}_deploys_total", s["deploys"][outcome],
                     {"outcome": outcome})
        b.family(f"{px}_swaps_total", "counter")
        b.sample(f"{px}_swaps_total", s["swaps"])
        b.family(f"{px}_canary_total", "counter")
        for verdict in sorted(s["canaries"]):
            b.sample(f"{px}_canary_total", s["canaries"][verdict],
                     {"verdict": verdict})
        b.family(f"{px}_rollbacks_total", "counter")
        for reason in sorted(s["rollback_reasons"]):
            b.sample(f"{px}_rollbacks_total",
                     s["rollback_reasons"][reason], {"reason": reason})
        b.family(f"{px}_retired_streams_total", "counter")
        b.sample(f"{px}_retired_streams_total", s["retired_streams"])
        b.family(f"{px}_in_progress", "gauge")
        b.sample(f"{px}_in_progress", s["in_progress"])
        if s["last_duration_s"] is not None:
            b.family(f"{px}_last_duration_seconds", "gauge")
            b.sample(f"{px}_last_duration_seconds", s["last_duration_s"],
                     round_to=4)
        if s["current_version"] is not None:
            b.family(f"{px}_version_info", "gauge")
            b.sample(f"{px}_version_info", 1,
                     {"version": s["current_version"]})
