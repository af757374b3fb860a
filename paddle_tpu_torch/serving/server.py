"""Threaded stdlib-HTTP serving front end (counterpart of
paddle_tpu/serving/server.py) over a `BatchingEngine` and/or an
`LLMEngine`:

    POST /predict   {"inputs": [[...], ...], "deadline_ms": 50}
                    -> 200 {"outputs": [...]}; 429 + Retry-After on an
                    overload reject; 503 draining or broken; 504 deadline
                    expired before dispatch
    POST /generate  {"input_ids": [...], "max_new_tokens": 32,
                    "eos_token_id": 2, "deadline_ms": 500,
                    "slo": "interactive"|"batch"|"best_effort",
                    "temperature": 0.8, "top_k": 40, "top_p": 0.95,
                    "seed": 1234, "grammar": {...}, "logprobs": true}
                    -> 200 {"tokens": [...], "ttft_ms": ..., "rid": ...}
                    from the continuous-batching LLMEngine; the same
                    429/503/504 mapping. An optional X-Tenant-Id header
                    (1-64 chars [A-Za-z0-9._-], malformed -> 400) selects
                    the tenant.
    GET  /healthz   -> 200 {"status": "ok"|"draining", "llm_*": ...};
                       503 {"status": "broken"} once an engine's circuit
                       breaker opens
    GET  /metrics   -> 200 Prometheus text exposition (serving/metrics.py)
    GET  /debug/requests[/<rid>]  -> finished request ids / one timeline
    GET  /debug/flightrecorder    -> the process-global black-box ring
    GET  /debug/costs             -> each engine's serving economics and
                                     SLO burn state (null unless armed)
    GET  /debug/compiles          -> 501: the compile observatory is not
                                     ported yet (ROADMAP item 9); /metrics
                                     therefore carries no pdtpu_compile_*
                                     family, as the JAX server renders
                                     none while the observatory is unarmed

Every request gets a request id, the trace id of a W3C `traceparent`
header when there is one, echoed as "rid"; `X-PDTPU-Trace: 1` also
returns the request's timeline inline as "trace".

Graceful drain, as in the JAX server: `stop()` (or SIGTERM/SIGINT under
`serve_forever`) stops admissions (new requests get 503), finishes every
admitted request through the engines, lets the handler threads write their
responses (non-daemon handlers and `block_on_close`, so `server_close()`
joins them), then writes `final_metrics_path`. An engine's circuit
breaker flips /healthz to 503 "broken" and starts that drain on its own
thread.

`serve(model_path)` and `main()` load an exported predictor, which waits
for the port's `inference/` (ROADMAP item 9): both raise.

    server = ServingServer(llm_engine=engine, port=8000).start()
"""
from __future__ import annotations

import json
import logging
import os
import re
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..obs.flight_recorder import flight_recorder
from ..obs.trace import ingest_traceparent, new_request_id
from .engine import (BatchingEngine, DeadlineExceededError, EngineConfig,
                     RejectedError)
from .llm.sampling import SamplingParams
from .metrics import SLO_CLASSES

_log = logging.getLogger("paddle_tpu_torch.serving")

# RejectedError reasons that mean "try again later" (HTTP 429 +
# Retry-After) rather than "this process is going away" (503)
_RETRYABLE_REJECTS = frozenset({"queue_full", "token_budget", "shed",
                                "tenant_quota"})

# X-Tenant-Id values the LLM routes accept: tenant ids become metric
# labels and prefix-cache namespaces, so a safe charset and bounded length
_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def read_request_body(handler, max_bytes=64 << 20):
    """Content-Length-checked body read (the JAX package's copy lives in
    its fleet KV server, distributed/fleet/utils/http_server.py, which
    the port has not ported yet). A missing Content-Length gets 411; a
    garbage, negative or oversized one, or a body shorter than declared,
    gets 400. Returns the body bytes, or None after an error response."""
    raw = handler.headers.get("Content-Length")
    if raw is None:
        handler.send_response(411)  # Length Required
        handler.end_headers()
        return None
    try:
        length = int(raw)
    except (TypeError, ValueError):
        length = -1
    if length < 0 or length > max_bytes:
        handler.send_response(400)
        handler.end_headers()
        return None
    body = handler.rfile.read(length) if length else b""
    if len(body) < length:  # client hung up mid-body
        handler.send_response(400)
        handler.end_headers()
        return None
    return body


def parse_generate(payload: dict, tenant: Optional[str]):
    """The /generate fields both HTTP faces share: (prompt, slo, tenant,
    sampling, logprobs). Raises ValueError / KeyError / TypeError on a
    malformed request (the caller's 400)."""
    prompt = np.asarray(payload["input_ids"], dtype=np.int32).reshape(-1)
    if prompt.size < 1:
        raise ValueError("input_ids must be non-empty")
    slo = payload.get("slo")
    if slo is not None and slo not in SLO_CLASSES:
        raise ValueError(
            f"slo must be one of {list(SLO_CLASSES)}, got {slo!r}")
    if tenant is not None and not _TENANT_ID_RE.match(tenant):
        raise ValueError(
            "malformed X-Tenant-Id (want 1-64 chars of [A-Za-z0-9._-], "
            f"starting alphanumeric), got {tenant!r}")
    # sampling fields: temperature / top_k / top_p / seed / grammar;
    # absent -> greedy (None)
    sampling = SamplingParams.from_payload(payload)
    if sampling is not None:
        sampling.validate()
    # per-token logprobs: strictly boolean, a truthy 1 or "yes" is a
    # malformed request
    want_lp = payload.get("logprobs", False)
    if not isinstance(want_lp, bool):
        raise ValueError(f"logprobs must be a boolean, got {want_lp!r}")
    return prompt, slo, tenant, sampling, want_lp


class HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for bursts of clients.
    socketserver's default backlog of 5, which the JAX servers keep, lets
    the kernel reset the connections of a burst beyond it that arrive
    before the accept loop catches up."""
    request_queue_size = 128


class JsonHandler(BaseHTTPRequestHandler):
    """Reply helpers both HTTP faces share."""

    def log_message(self, *args):
        pass

    def _reply(self, code: int, body: bytes,
               ctype: str = "application/json", headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, headers=None):
        self._reply(code, json.dumps(obj).encode(), headers=headers)

    def _reply_rejected(self, e: RejectedError, retryable=_RETRYABLE_REJECTS):
        """Overload -> 429 + Retry-After (back off and come back);
        draining/broken/structural -> 503 (find another replica)."""
        reason = getattr(e, "reason", "rejected")
        if reason in retryable:
            retry_s = getattr(e, "retry_after_s", None) or 1.0
            self._reply_json(429, {"error": str(e), "reason": reason},
                             headers={"Retry-After": f"{retry_s:g}"})
        else:
            self._reply_json(503, {"error": str(e), "reason": reason})

    def _request_rid(self) -> str:
        """The W3C traceparent trace-id when the client sent one, else a
        fresh id."""
        return (ingest_traceparent(self.headers.get("traceparent"))
                or new_request_id())


def _decode_inputs(payload: dict):
    """JSON request body -> list of np arrays (leading batch dim). Each
    entry is either a nested list (float32) or {"data": ..., "dtype": ...}."""
    inputs = payload.get("inputs")
    if inputs is None:
        raise ValueError('request body needs an "inputs" list')
    arrays = []
    for entry in inputs:
        if isinstance(entry, dict):
            arrays.append(np.asarray(entry["data"],
                                     dtype=entry.get("dtype", "float32")))
        else:
            arrays.append(np.asarray(entry, dtype=np.float32))
    return arrays


class ServingServer:
    """HTTP front end and drain orchestration around a BatchingEngine
    (stateless /predict) and/or an LLMEngine (/generate). At least one
    engine must be attached; each route 404s when its engine is absent.
    Both share the drain contract: stop admissions, finish every admitted
    request, snapshot the final metrics."""

    def __init__(self, engine: Optional[BatchingEngine] = None,
                 host: str = "127.0.0.1",
                 port: int = 0, final_metrics_path: Optional[str] = None,
                 request_timeout_s: float = 60.0, llm_engine=None):
        if engine is None and llm_engine is None:
            raise ValueError(
                "ServingServer needs a BatchingEngine (/predict), an "
                "LLMEngine (/generate), or both")
        self.engine = engine
        self.llm_engine = llm_engine
        self._thread: Optional[threading.Thread] = None
        self.final_metrics_path = final_metrics_path
        self.request_timeout_s = float(request_timeout_s)
        self._draining = False
        self._stop_lock = threading.Lock()
        self._stopped_event = threading.Event()
        self._active = 0                 # handler threads inside a POST route
        self._active_lock = threading.Lock()
        outer = self

        class _Handler(JsonHandler):
            def _trace_wanted(self) -> bool:
                return self.headers.get("X-PDTPU-Trace", "").strip() == "1"

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply_json(*outer.healthz())
                elif self.path == "/metrics":
                    # both engines scrape from one endpoint; the llm family
                    # renders under pdtpu_llm_* so names never collide
                    text = "".join(e.metrics.render()
                                   for e in outer._engines())
                    self._reply(200, text.encode(),
                                ctype="text/plain; version=0.0.4")
                elif self.path == "/debug/flightrecorder":
                    self._reply_json(200, flight_recorder().snapshot())
                elif self.path == "/debug/costs":
                    costs = {}
                    for name, e in (("predict", outer.engine),
                                    ("llm", outer.llm_engine)):
                        if e is None:
                            continue
                        led = getattr(e, "ledger", None)
                        burn = getattr(e, "burn", None)
                        costs[name] = {
                            "economics": (led.snapshot()
                                          if led is not None else None),
                            "slo_burn": (burn.snapshot()
                                         if burn is not None else None),
                        }
                    self._reply_json(200, costs)
                elif self.path == "/debug/compiles":
                    self._reply_json(501, {
                        "error": "the compile observatory "
                                 "(obs/compile_observatory.py) is not "
                                 "ported yet: ROADMAP item 9",
                        "reason": "not_ported"})
                elif self.path == "/debug/requests":
                    ids = []
                    for e in outer._engines():
                        ids.extend(e.timelines.ids())
                    self._reply_json(200, {"ids": ids})
                elif self.path.startswith("/debug/requests/"):
                    rid = self.path[len("/debug/requests/"):]
                    for e in outer._engines():
                        tl = e.timelines.get(rid)
                        if tl is not None:
                            self._reply_json(200, tl)
                            return
                    self._reply_json(
                        404, {"error": f"no timeline for request {rid!r} "
                              "(untraced, unfinished, or evicted from the "
                              "bounded timeline buffer)"})
                else:
                    self._reply_json(404, {"error": "not found"})

            def do_POST(self):
                routes = {"/predict": (outer.engine, self._predict),
                          "/generate": (outer.llm_engine, self._generate)}
                route = routes.get(self.path)
                if route is None or route[0] is None:
                    self._reply_json(404, {"error": "not found"})
                    return
                body = read_request_body(self)
                if body is None:
                    return
                with outer._active_lock:
                    outer._active += 1
                try:
                    route[1](body)
                finally:
                    with outer._active_lock:
                        outer._active -= 1

            def _generate(self, body: bytes):
                try:
                    payload = json.loads(body or b"{}")
                    prompt, slo, tenant, sampling, want_lp = parse_generate(
                        payload, self.headers.get("X-Tenant-Id"))
                except (ValueError, KeyError, TypeError) as e:
                    self._reply_json(400, {"error": f"bad request: {e}"})
                    return
                rid = self._request_rid()
                traced = self._trace_wanted()
                try:
                    handle = outer.llm_engine.submit(
                        prompt,
                        max_new_tokens=payload.get("max_new_tokens"),
                        eos_token_id=payload.get("eos_token_id"),
                        deadline_ms=payload.get("deadline_ms"),
                        slo=slo, tenant=tenant, rid=rid, trace=traced,
                        sampling=sampling, logprobs=want_lp)
                    toks = handle.result(timeout=outer.request_timeout_s)
                except RejectedError as e:
                    self._reply_rejected(e)
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
                }
                if want_lp:
                    resp["logprobs"] = handle.logprobs_so_far()
                if traced:
                    resp["trace"] = handle.timeline()
                self._reply_json(200, resp)

            def _predict(self, body: bytes):
                try:
                    payload = json.loads(body or b"{}")
                    arrays = _decode_inputs(payload)
                except (ValueError, KeyError, TypeError) as e:
                    self._reply_json(400, {"error": f"bad request: {e}"})
                    return
                rid = self._request_rid()
                traced = self._trace_wanted()
                try:
                    fut = outer.engine.submit(
                        arrays, deadline_ms=payload.get("deadline_ms"),
                        rid=rid, trace=traced)
                    outs = fut.result(timeout=outer.request_timeout_s)
                except RejectedError as e:
                    self._reply_rejected(e)
                    return
                except DeadlineExceededError as e:
                    self._reply_json(504, {"error": str(e)})
                    return
                except Exception as e:  # model/dispatch failure
                    self._reply_json(
                        500, {"error": f"{type(e).__name__}: {e}"})
                    return
                resp = {
                    "outputs": [np.asarray(o).tolist() for o in outs],
                    "rid": rid,
                }
                if traced:
                    # the engine publishes the timeline before resolving
                    # the future, so it is visible here
                    resp["trace"] = outer.engine.timelines.get(rid)
                self._reply_json(200, resp)

        # socket-level cap so a stalled client can't pin a handler thread
        # past the drain settle window
        _Handler.timeout = self.request_timeout_s + 30.0
        self._server = HTTPServer((host, port), _Handler)
        # non-daemon handlers + block_on_close: server_close() joins every
        # in-flight handler, so the final snapshot is written strictly
        # after the last response
        self._server.daemon_threads = False
        self._server.block_on_close = True
        self.host, self.port = self._server.server_address[:2]
        # circuit-breaker escalation: the trip fires on the engine's
        # scheduler thread, which cannot join itself, so the drain runs on
        # a fresh thread while /healthz reports "broken"
        for e in self._engines():
            if hasattr(e, "on_break") and e.on_break is None:
                e.on_break = self._drain_on_break

    def healthz(self):
        """(HTTP code, body) of /healthz."""
        engines = self._engines()
        broken = any(getattr(e, "broken", False) for e in engines)
        # an engine-initiated drain (its stop(), breaker escalation) leaves
        # the server's flag down while submissions already get 503
        # "draining": a router must see that drain here
        draining = self._draining or any(getattr(e, "draining", False)
                                         for e in engines)
        health = {"status": ("broken" if broken else
                             "draining" if draining else "ok")}
        if self.engine is not None:
            health["queue_depth"] = self.engine.metrics.queue_depth
        if self.llm_engine is not None:
            eng = self.llm_engine
            m = eng.metrics
            health["llm_queue_depth"] = m.queue_depth
            health["llm_weight_version"] = eng.weight_version
            health["llm_slots_active"] = m.slots_active
            health["llm_slots_total"] = m.slots_total
            health["llm_inflight_tokens"] = eng.inflight_tokens()
            health["llm_prefix_probe"] = eng.prefix_cache is not None
            snap = m.snapshot()
            health["llm_prefix_hit_rate"] = round(
                snap.get("prefix_hit_rate", 0.0), 4)
            health["llm_cached_blocks"] = snap.get("cached_blocks", 0)
            health["llm_tenants"] = {
                t: {"cache_hit_rate": round(v["cache_hit_rate"], 4),
                    "cached_blocks": v["cached_blocks"],
                    "inflight_tokens": v["inflight_tokens"]}
                for t, v in snap.get("tenants", {}).items()}
        return (503 if broken else 200), health

    def _drain_on_break(self):
        _log.error("engine circuit breaker open; draining server")
        threading.Thread(target=self.stop, daemon=True,
                         name="pdtt-serving-breaker-drain").start()

    # ---- lifecycle ----
    def _engines(self):
        return [e for e in (self.engine, self.llm_engine) if e is not None]

    def start(self) -> "ServingServer":
        """Engine scheduler(s) + HTTP accept loop on background threads."""
        for e in self._engines():
            e.start()
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="pdtt-serving-http")
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop admissions, flush the engines, stop the HTTP server.
        Idempotent; the loser of a concurrent stop race waits for the
        winner to finish."""
        with self._stop_lock:
            already = self._draining
            self._draining = True
        drain_s = max(e.config.drain_timeout_s for e in self._engines())
        if already:
            self._stopped_event.wait(timeout=drain_s + 15.0)
            return
        for e in self._engines():
            e.stop(drain=drain)
        self._wait_active_settled()
        self._server.shutdown()
        self._server.server_close()
        if self.final_metrics_path:
            tmp = self.final_metrics_path + ".tmp"
            with open(tmp, "w") as f:
                f.write("".join(e.metrics.render()
                                for e in self._engines()))
            os.replace(tmp, self.final_metrics_path)
        self._stopped_event.set()

    def _wait_active_settled(self, timeout: float = 10.0):
        """Let handler threads holding already-resolved futures finish
        writing their responses before the accept loop dies: the 'no
        accepted request is dropped' half of the drain contract."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._active_lock:
                settled = self._active == 0
            if settled:
                # brief double-check window for a just-accepted socket
                # whose handler hasn't registered itself yet
                time.sleep(0.05)
                with self._active_lock:
                    if self._active == 0:
                        return
                continue
            time.sleep(0.01)
        with self._active_lock:
            still = self._active
        _log.warning("drain settle window (%.1fs) expired with %d "
                     "handler(s) still active; their clients may see a "
                     "connection reset", timeout, still)

    def serve_forever(self, install_signal_handlers: bool = True):
        """Foreground serve loop with the SIGTERM drain contract: returns
        after a graceful drain (the caller exits 0)."""
        if install_signal_handlers:
            def _on_term(signum, frame):
                # black-box dump first: if the drain wedges and a
                # supervisor escalates to SIGKILL, the postmortem still
                # has everything up to the signal
                fr = flight_recorder()
                fr.record("sigterm", signum=int(signum))
                fr.try_dump(reason="sigterm")
                # shutdown() would deadlock on the main thread blocked in
                # serve_forever: drain from a helper thread
                threading.Thread(target=self.stop, daemon=True,
                                 name="pdtt-serving-drain").start()
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, _on_term)
        for e in self._engines():
            e.start()
        try:
            if self._thread is not None:
                # start() already owns an accept loop; a second
                # serve_forever on the same socket would survive shutdown()
                self._stopped_event.wait()
            else:
                self._server.serve_forever(poll_interval=0.05)
        finally:
            # the signal's drain thread owns stop(): wait for it, so the
            # final snapshot is never half-written
            self.stop()


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8000,
          config: Optional[EngineConfig] = None,
          final_metrics_path: Optional[str] = None) -> ServingServer:
    """Load an exported model (inference.export_model artifacts) and return
    a ready-to-start ServingServer: waits for the port's `inference/`
    (`load_predictor`, `BatchingEngine.from_predictor`), ROADMAP item 9."""
    raise NotImplementedError(
        f"serve({model_path!r}) loads an exported predictor, and the port's "
        "inference/ (load_predictor) is not ported yet: ROADMAP item 9. "
        "Build a ServingServer over an engine instead")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True,
                    help="export_model artifact prefix")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-queue-depth", type=int, default=256)
    ap.add_argument("--max-request-rows", type=int, default=None,
                    help="reject single requests larger than this many rows")
    ap.add_argument("--final-metrics", default=None)
    args = ap.parse_args(argv)
    server = serve(args.model, host=args.host, port=args.port,
                   config=EngineConfig(max_batch_size=args.max_batch_size,
                                       max_wait_ms=args.max_wait_ms,
                                       max_queue_depth=args.max_queue_depth,
                                       max_request_rows=args.max_request_rows),
                   final_metrics_path=args.final_metrics)
    print(f"serving {args.model} on {server.host}:{server.port}",
          file=sys.stderr)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
