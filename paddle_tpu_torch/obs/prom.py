"""Prometheus text-exposition plumbing, format 0.0.4 (counterpart of
paddle_tpu/obs/prom.py):

- `PromBuilder` — family/sample line building (with
  `escape_label_value`, the label escaping every family shares);
- `parse_exposition` — the inverse, for tests/tools;
- `TrainingMetrics` — the `pdtpu_train_*` family: step/chunk throughput
  from `profiler.ThroughputTracker` plus rollback/retry/checkpoint
  counters fed by `ResilientTrainer`, with the JAX package's family
  names;
- `MetricsServer` — a tiny opt-in stdlib HTTP exporter (`metrics_port=`)
  serving `/metrics`, `/debug/flightrecorder`, `/debug/numerics` (the
  process-current numerics observatory's snapshot, or `{"armed":
  false}`) and `/healthz`. The JAX server's `/debug/compiles` reads the
  compile observatory, which the port does not have yet (ROADMAP §1 item
  9); it answers 404 here.

Stdlib only.
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Sequence


def escape_label_value(value) -> str:
    """Escape a label value per the Prometheus exposition spec (0.0.4):
    backslash, double-quote, and newline. Label values reach here from
    user-controlled strings (tenant ids via X-Tenant-Id, request ids) —
    without this, a crafted value injects extra samples or labels into
    the scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(value: str) -> str:
    out: List[str] = []
    i, n = 0, len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt,
                                                             "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class PromBuilder:
    """Accumulates exposition lines; label order is preserved."""

    def __init__(self):
        self._lines: List[str] = []

    def family(self, name: str, typ: str) -> "PromBuilder":
        self._lines.append(f"# TYPE {name} {typ}")
        return self

    def sample(self, name: str, value, labels: Optional[dict] = None,
               round_to: Optional[int] = None) -> "PromBuilder":
        lab = ""
        if labels:
            inner = ",".join(f'{k}="{escape_label_value(v)}"'
                             for k, v in labels.items())
            lab = "{" + inner + "}"
        if value is None:
            v = "NaN"
        elif round_to is not None:
            v = round(float(value), round_to)
        else:
            v = value
        self._lines.append(f"{name}{lab} {v}")
        return self

    def raw(self, line: str) -> "PromBuilder":
        self._lines.append(line)
        return self

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


def _parse_labels(line: str, start: int) -> Optional[tuple]:
    """Parse the `{k="v",...}` block starting at `line[start] == "{"`,
    honoring value escapes; returns ([(key, raw_value)], index past the
    closing brace) or None when malformed."""
    labels: List[tuple] = []
    i, n = start + 1, len(line)
    while i < n and line[i] != "}":
        eq = line.find("=", i)
        if eq == -1 or eq + 1 >= n or line[eq + 1] != '"':
            return None
        key = line[i:eq].strip().lstrip(",").strip()
        j = eq + 2
        buf: List[str] = []
        while j < n and line[j] != '"':
            if line[j] == "\\" and j + 1 < n:
                buf.append(line[j:j + 2])
                j += 2
            else:
                buf.append(line[j])
                j += 1
        if j >= n:
            return None
        labels.append((key, "".join(buf)))
        i = j + 1
        if i < n and line[i] == ",":
            i += 1
    if i >= n:
        return None
    return labels, i + 1


def parse_exposition(text: str) -> Dict[str, float]:
    """Inverse of render() for tests/tools: flat {metric{labels}: value}.

    Escape-aware: label values are tokenized honoring `\\"` / `\\\\` /
    `\\n` and re-escaped canonically into the key, so
    parse_exposition(render()) round-trips every sample — one entry per
    sample line, whatever bytes the label values carried."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            parsed = _parse_labels(line, brace)
            if parsed is None:
                continue
            labels, end = parsed
            inner = ",".join(
                f'{k}="{escape_label_value(_unescape_label_value(v))}"'
                for k, v in labels)
            name = line[:brace] + "{" + inner + "}"
            val = line[end:].strip()
        else:
            name, _, val = line.rpartition(" ")
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out


class TrainingMetrics:
    """Training-side counters under the `pdtpu_train_*` prefix.

    Fed by `ResilientTrainer._event` (every fault/recovery event maps to a
    counter) and its checkpoint-save sites; throughput gauges read the
    `DeviceWorker.throughput` tracker so the /metrics scrape reports the
    same numbers the chunk loop logs."""

    _PREFIX = "pdtpu_train"

    # ResilientTrainer event kind -> counter name
    _EVENT_COUNTERS = {
        "retry": "retries", "rollback": "rollbacks", "skip": "skips",
        "bad_loss": "bad_losses", "watchdog_timeout": "watchdog_timeouts",
        "step_error": "step_errors", "preempted": "preemptions",
        "resumed": "resumes", "checkpoint_save": "checkpoint_saves",
    }

    def __init__(self, tracker=None, ledger=None, hbm=None, sentinel=None,
                 numerics=None, ckpt=None):
        self._lock = threading.Lock()
        self.tracker = tracker  # profiler.ThroughputTracker or None
        # goodput providers, all optional and sampled at render
        # time (scrape-rate cost, never step-rate cost):
        self.ledger = ledger        # obs.goodput.GoodputLedger
        self.hbm = hbm              # obs.goodput.HBMTelemetry
        self.sentinel = sentinel    # obs.goodput.RecompileSentinel
        self.numerics = numerics    # obs.numerics.NumericsObservatory
        self.ckpt = ckpt            # checkpoint.AsyncCheckpointManager
        self.counters: Dict[str, int] = {
            v: 0 for v in self._EVENT_COUNTERS.values()}
        self.last_step = 0

    def on_event(self, kind: str, step: int = 0):
        key = self._EVENT_COUNTERS.get(kind)
        with self._lock:
            if key is not None:
                self.counters[key] += 1
            self.last_step = max(self.last_step, int(step))

    def set_step(self, step: int):
        with self._lock:
            self.last_step = max(self.last_step, int(step))

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.counters)
            s["last_step"] = self.last_step
        if self.tracker is not None:
            s.update(self.tracker.summary())
        if self.ledger is not None:
            s["goodput"] = self.ledger.snapshot()
        if self.hbm is not None:
            s["hbm"] = self.hbm.snapshot()
        if self.sentinel is not None:
            s["recompile"] = self.sentinel.snapshot()
        if self.numerics is not None:
            s["numerics"] = self.numerics.snapshot()
        if self.ckpt is not None:
            s["ckpt"] = self.ckpt.stats()
        return s

    def render(self) -> str:
        s = self.snapshot()
        px = self._PREFIX
        b = PromBuilder()
        for name in sorted(self._EVENT_COUNTERS.values()):
            b.family(f"{px}_{name}_total", "counter")
            b.sample(f"{px}_{name}_total", s[name])
        b.family(f"{px}_last_step", "gauge")
        b.sample(f"{px}_last_step", s["last_step"])
        if self.tracker is not None:
            keys = [("steps_per_sec", "gauge"),
                    ("tokens_per_sec", "gauge"),
                    ("total_steps", "counter"),
                    ("total_tokens", "counter"),
                    ("total_seconds", "counter"),
                    ("last_chunk_seconds", "gauge")]
            if "mfu" in s:  # tracker with registered flops
                keys.append(("mfu_window", "gauge"))
                s["mfu_window"] = s["mfu"]
            for key, typ in keys:
                b.family(f"{px}_{key}", typ)
                b.sample(f"{px}_{key}", s[key], round_to=4)
        if self.ledger is not None:
            g = s["goodput"]
            b.family(f"{px}_goodput", "gauge")
            b.sample(f"{px}_goodput", g["goodput"], round_to=4)
            b.family(f"{px}_mfu", "gauge")
            b.sample(f"{px}_mfu", g["mfu"], round_to=4)  # NaN when unset
            b.family(f"{px}_wall_seconds", "gauge")
            b.sample(f"{px}_wall_seconds", g["wall_seconds"], round_to=4)
            b.family(f"{px}_phase_seconds_total", "counter")
            for phase, secs in sorted(g["phase_seconds"].items()):
                b.sample(f"{px}_phase_seconds_total", secs,
                         labels={"phase": phase}, round_to=4)
        if self.sentinel is not None:
            r = s["recompile"]
            b.family(f"{px}_compiles_total", "counter")
            b.sample(f"{px}_compiles_total", r["compiles"])
            b.family(f"{px}_recompiles_total", "counter")
            b.sample(f"{px}_recompiles_total", r["recompiles"])
            b.family(f"{px}_compile_seconds_total", "counter")
            b.sample(f"{px}_compile_seconds_total", r["compile_seconds"],
                     round_to=4)
        if self.hbm is not None:
            h = s["hbm"]
            for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                if key in h:  # absent on backends without memory_stats()
                    b.family(f"{px}_hbm_{key}", "gauge")
                    b.sample(f"{px}_hbm_{key}", h[key])
            if h.get("attributed"):
                b.family(f"{px}_hbm_attributed_bytes", "gauge")
                for comp, nbytes in sorted(h["attributed"].items()):
                    b.sample(f"{px}_hbm_attributed_bytes", nbytes,
                             labels={"component": comp})
        if self.ckpt is not None:
            # pdtpu_train_ckpt_*: the continuous-checkpointing pipeline
            # (AsyncCheckpointManager.stats) — snapshots taken, persisted,
            # dropped under backpressure, emergency saves, scrubber
            # quarantines, and the blocking/background seconds split
            c = s["ckpt"]
            for key in ("snapshots", "persisted", "dropped",
                        "persist_errors", "emergency_saves",
                        "corrupt_quarantined"):
                b.family(f"{px}_ckpt_{key}_total", "counter")
                b.sample(f"{px}_ckpt_{key}_total", c[key])
            for key in ("lag_seconds_total", "blocking_seconds_total",
                        "async_seconds_total"):
                b.family(f"{px}_ckpt_{key}", "counter")
                b.sample(f"{px}_ckpt_{key}", c[key], round_to=4)
            b.family(f"{px}_ckpt_queue_depth", "gauge")
            b.sample(f"{px}_ckpt_queue_depth", c["queue_depth"])
            b.family(f"{px}_ckpt_last_lag_seconds", "gauge")
            b.sample(f"{px}_ckpt_last_lag_seconds", c["last_lag_seconds"],
                     round_to=4)
        text = b.render()
        if self.numerics is not None:
            # pdtpu_train_numerics_* families; "" until the observatory
            # has recorded anything, so unarmed scrapes stay byte-identical
            text += self.numerics.render_prom()
        return text


class MetricsServer:
    """Opt-in stdlib HTTP exporter for processes without a ServingServer
    (trainers): GET /metrics renders the given providers, GET
    /debug/flightrecorder snapshots the global flight recorder, GET
    /debug/numerics the current numerics observatory, GET /healthz
    answers ok. Bind port 0 for an ephemeral port (tests)."""

    def __init__(self, render_fns: Sequence[Callable[[], str]],
                 host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        render_fns = list(render_fns)

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    text = "".join(fn() for fn in render_fns)
                    self._reply(200, text.encode(),
                                "text/plain; version=0.0.4")
                elif self.path == "/debug/flightrecorder":
                    from .flight_recorder import flight_recorder
                    body = json.dumps(flight_recorder().snapshot()).encode()
                    self._reply(200, body, "application/json")
                elif self.path == "/debug/numerics":
                    from .numerics import debug_snapshot
                    body = json.dumps(debug_snapshot()).encode()
                    self._reply(200, body, "application/json")
                elif self.path == "/healthz":
                    self._reply(200, b"ok\n", "text/plain")
                else:
                    self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="pdtpu-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
