"""The port's HTTP front end (`serving/server.py`) and the engine repairs
the front end needs, against the JAX package (tests/test_serving.py's,
tests/test_router.py's and tests/test_tiered.py's server contracts), on
gpt2-tiny twins with bridged weights.

- The same HTTP requests to both packages' `ServingServer` over a live
  `LLMEngine`: status codes, bodies (tokens equal, logprobs within 1e-4)
  and Retry-After; 400 on a malformed X-Tenant-Id, slo, logprobs or body,
  411 without a Content-Length, 429 on a tenant quota, 504 on a deadline,
  503 once the engine drains; /healthz with its `llm_*` keys (among them
  `llm_weight_version`), /metrics, /debug/requests, /debug/costs,
  /debug/flightrecorder; a traceparent's trace id as the rid.
- `/predict` over both packages' `BatchingEngine`: 429 + Retry-After on
  a full queue, then 503 "broken" and "circuit_open" after a breaker
  trip; a breaker trip that drains the server through `on_break`, and
  the drain's final metrics file.
- What the port does not have yet answers typed: `/debug/compiles` 501
  and `serve(model_path)` NotImplementedError, both naming ROADMAP item 9.
- Engine repairs: `LLMEngineConfig` holds JAX's fields but `observatory`
  (38 of 39), `weight_version` defaults to "v0" and must be non-empty,
  and `evacuate` fails the same requests with the same reasons, metrics
  and flight event as JAX's.
"""
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_port import (drain, engine_pair, one_torch_thread,  # noqa: F401
                         share_jax_steps, tiny_models)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_slots=4, block_len=8, n_blocks=4, max_queue_depth=64)
JAX_STEPS = {}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _http(base, path, body=None, headers=None, raw=None):
    """(status, JSON body or text, Retry-After) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, text, retry = r.status, r.read(), None
    except urllib.error.HTTPError as e:
        code, text, retry = e.code, e.read(), e.headers.get("Retry-After")
    try:
        return code, json.loads(text), retry
    except ValueError:
        return code, text.decode(), retry


def _no_length(port):
    """The status line a POST without Content-Length gets."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n\r\n")
        return s.recv(200).decode().splitlines()[0]
    finally:
        s.close()


def _llm_servers(models, tmp_path, **over):
    """Both packages' ServingServer over a live LLMEngine (a
    MonotonicClock scheduler thread) of config CFG + `over`, each with a
    final metrics path under tmp_path, started."""
    from paddle_tpu import serving as jserving
    from paddle_tpu_torch import serving as tserving
    jm, tm = models
    cfg = {**CFG, **over}
    je = jserving.LLMEngine(jm, jserving.LLMEngineConfig(**cfg))
    share_jax_steps(je, jm, JAX_STEPS)
    te = tserving.LLMEngine(tm, tserving.LLMEngineConfig(**cfg))
    return [pkg.ServingServer(
        llm_engine=e, port=0,
        final_metrics_path=str(tmp_path / f"final_{i}.txt")).start()
        for i, (pkg, e) in enumerate(((jserving, je), (tserving, te)))]


TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
GENERATE_CASES = [
    # (body, headers): a greedy stream with logprobs under a tenant
    ({"input_ids": [5, 6, 7, 8, 9], "max_new_tokens": 6, "logprobs": True},
     {"X-Tenant-Id": "acme.1"}),
    # seeded top-k / top-p sampling, traced, with a W3C traceparent
    ({"input_ids": [11, 12, 13], "max_new_tokens": 6, "temperature": 0.8,
      "top_k": 40, "top_p": 0.95, "seed": 1234, "slo": "interactive"},
     {"X-PDTPU-Trace": "1",
      "traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-01"}),
    # a tenant quota reject: 10 + 8 tokens against a quota of 16
    ({"input_ids": list(range(1, 11)), "max_new_tokens": 8},
     {"X-Tenant-Id": "small"}),
    ({"input_ids": [5, 6], "max_new_tokens": 4, "deadline_ms": 0.001},
     None),                                                  # 504
    ({"input_ids": [5, 6, 7]}, {"X-Tenant-Id": "-bad"}),     # 400s
    ({"input_ids": [5], "slo": "gold"}, None),
    ({"input_ids": [5], "logprobs": 1}, None),
    ({"input_ids": [5], "temperature": -1.0, "seed": 1}, None),
    ({"input_ids": []}, None),
    ({"prompt": [5]}, None),
]


def test_generate_codes_bodies_and_health_match_jax(models, tmp_path):
    """The same requests to both packages' ServingServer: codes, bodies,
    Retry-After, healthz, costs, request timelines and metric families
    alike; then an engine-side drain reads "draining" and 503s, and the
    server's stop writes the final metrics."""
    from paddle_tpu_torch import serving
    servers = _llm_servers(models, tmp_path, tenant_max_inflight_tokens=16,
                           retry_after_s=2.5)
    bases = [f"http://127.0.0.1:{s.port}" for s in servers]
    try:
        got = [[_http(b, "/generate", body, hdr)
                for body, hdr in GENERATE_CASES] for b in bases]
        got_raw = [_http(b, "/generate", raw=b"{not json",
                         headers={"Content-Type": "application/json"})
                   for b in bases]
        for (jc, jb, jra), (tc, tb, tra) in zip(got[0] + [got_raw[0]],
                                                got[1] + [got_raw[1]]):
            assert (tc, tra) == (jc, jra), (jb, tb)
            if jc == 200:
                assert tb["tokens"] == jb["tokens"]
                assert set(tb) == set(jb)
                if "logprobs" in jb:
                    np.testing.assert_allclose(tb["logprobs"],
                                               jb["logprobs"], atol=1e-4)
            else:
                assert set(tb) == set(jb)
                if "reason" in jb:
                    assert tb["reason"] == jb["reason"]
                # the same message but for measured times
                assert re.sub(r"[\d.]+ms", "", tb["error"]) == \
                    re.sub(r"[\d.]+ms", "", jb["error"])
        codes = [c for c, _, _ in got[1]]
        assert codes == [200, 200, 429, 504, 400, 400, 400, 400, 400, 400]
        assert got[1][2][1]["reason"] == "tenant_quota"
        assert got[1][2][2] == "2.5"
        traced = got[1][1][1]
        assert traced["rid"] == TRACE_ID
        # the request's timeline, inline and from /debug/requests
        tl = [_http(b, f"/debug/requests/{TRACE_ID}") for b in bases]
        assert tl[1][0] == tl[0][0] == 200
        assert set(tl[1][1]) == set(tl[0][1]) == set(traced["trace"])
        assert [p["name"] for p in tl[1][1]["phases"]] == \
            [p["name"] for p in tl[0][1]["phases"]]
        ids = [_http(b, "/debug/requests") for b in bases]
        assert TRACE_ID in ids[1][1]["ids"] and TRACE_ID in ids[0][1]["ids"]
        assert [_http(b, "/debug/requests/none")[0] for b in bases] == \
            [404, 404]

        gets = [[_http(b, p) for p in ("/healthz", "/debug/costs",
                                       "/predict", "/nothing")]
                for b in bases]
        assert gets[1] == gets[0]
        health = gets[1][0][1]
        assert health["llm_weight_version"] == "v0"
        assert set(health["llm_tenants"]) == {"acme.1", "default", "small"}
        assert gets[1][1][1] == {"llm": {"economics": None,
                                         "slo_burn": None}}
        assert [_no_length(s.port).split()[1] for s in servers] == \
            ["411", "411"]
        metrics = [serving.parse_exposition(_http(b, "/metrics")[1])
                   for b in bases]
        # the JAX scrape adds pdtpu_compile_* once anything in the process
        # armed its (process-global) compile observatory; the port has none
        llm = [{k for k in m if k.startswith("pdtpu_llm_")} for m in metrics]
        assert llm[1] == llm[0] and set(metrics[1]) == llm[1]
        for key in ('pdtpu_llm_requests_total{outcome="completed"}',
                    'pdtpu_llm_requests_total{outcome="rejected"}',
                    'pdtpu_llm_requests_total{outcome="expired"}'):
            assert metrics[1][key] == metrics[0][key]
        fr = [_http(b, "/debug/flightrecorder") for b in bases]
        assert fr[1][0] == 200 and set(fr[1][1]) == set(fr[0][1])
        assert _http(bases[1], "/debug/compiles")[:2] == (501, {
            "error": "the compile observatory (obs/compile_observatory.py) "
                     "is not ported yet: ROADMAP item 9",
            "reason": "not_ported"})

        for s in servers:
            s.llm_engine.stop(drain=True, timeout=30)  # engine-side drain
        after = [[_http(b, "/healthz")[1]["status"],
                  _http(b, "/generate", {"input_ids": [5],
                                         "max_new_tokens": 4})[:2]]
                 for b in bases]
        assert after[1] == after[0]
        assert after[1][0] == "draining"
        assert after[1][1][0] == 503 and after[1][1][1]["reason"] == \
            "draining"
    finally:
        for s in servers:
            s.stop()
            s.stop()                # idempotent
    finals = [serving.parse_exposition(open(s.final_metrics_path).read())
              for s in servers]
    assert finals[1]['pdtpu_llm_requests_total{outcome="completed"}'] == \
        finals[0]['pdtpu_llm_requests_total{outcome="completed"}'] == 2


def _predict_scenario(pkg):
    """tests/test_serving.py's backpressure scenario on `pkg`'s
    BatchingEngine behind its ServingServer: what each request got."""
    gate, entered = threading.Event(), threading.Event()

    def slow_predict(arrays):
        entered.set()
        gate.wait(30)
        return [arrays[0] * 2]

    eng = pkg.BatchingEngine(
        slow_predict,
        pkg.EngineConfig(max_batch_size=1, max_wait_ms=0.0,
                         max_queue_depth=1, retry_after_s=2.5),
        on_break=lambda: None)      # keep the server up after the trip
    srv = pkg.ServingServer(eng, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    out = []
    try:
        done = [[], []]

        def post(box, x):
            box.append(_http(base, "/predict", {"inputs": [[x]]}))

        threading.Thread(target=post, args=(done[0], [1.0, 2.0])).start()
        assert entered.wait(20)
        threading.Thread(target=post, args=(done[1], [3.0, 4.0])).start()
        deadline = time.time() + 20
        while eng.metrics.queue_depth < 1:
            assert time.time() < deadline
            time.sleep(0.01)
        out.append(_http(base, "/predict", {"inputs": [[[9.0, 9.0]]]}))
        out.append(_http(base, "/predict", {"wrong_key": 1}))
        gate.set()
        deadline = time.time() + 30
        while not (done[0] and done[1]):
            assert time.time() < deadline
            time.sleep(0.01)
        out += [done[0][0], done[1][0], _http(base, "/healthz")]
        for _ in range(eng.config.breaker_threshold):
            eng.supervisor.record_failure()
        out.append(_http(base, "/healthz"))
        out.append(_http(base, "/predict", {"inputs": [[[9.0, 9.0]]]}))
        out.append(_http(base, "/generate", {"input_ids": [1]}))
    finally:
        gate.set()
        srv.stop()
    # the request id is random: keep its presence only
    return [(c, {k: (v if k != "rid" else "rid") for k, v in b.items()}
             if isinstance(b, dict) else b, r) for c, b, r in out]


def test_predict_backpressure_and_breaker_match_jax():
    """/predict over both packages' BatchingEngine: 200 with the same
    outputs, 400 on a body without inputs, 429 + Retry-After 2.5 on a
    full queue, then a tripped breaker's 503 "broken" healthz and 503
    "circuit_open"; /generate 404s without an LLM engine."""
    from paddle_tpu import serving as jserving
    from paddle_tpu_torch import serving as tserving
    j, t = _predict_scenario(jserving), _predict_scenario(tserving)
    assert [(c, r) for c, _, r in t] == [(c, r) for c, _, r in j] == [
        (429, "2.5"), (400, None), (200, None), (200, None), (200, None),
        (503, None), (503, None), (404, None)]
    for (_, jb, _), (_, tb, _) in zip(j, t):
        assert set(tb) == set(jb)
        for k in ("outputs", "reason", "status"):
            if k in jb:
                assert tb[k] == jb[k]
    assert t[0][1]["reason"] == "queue_full"
    assert t[5][1]["status"] == "broken"
    assert t[6][1]["reason"] == "circuit_open"


def test_breaker_trip_drains_server_and_unported_routes(tmp_path):
    """A breaker trip drains the server on its own thread through the
    on_break hook the server claims; the drain writes the final metrics.
    serve(model_path) raises NotImplementedError naming ROADMAP item 9."""
    from paddle_tpu_torch import serving
    eng = serving.BatchingEngine(
        lambda a: [a[0]], serving.EngineConfig(max_batch_size=1,
                                               max_wait_ms=0.0,
                                               breaker_threshold=1))
    path = str(tmp_path / "final.txt")
    srv = serving.ServingServer(eng, port=0, final_metrics_path=path).start()
    code, body, _ = _http(f"http://127.0.0.1:{srv.port}", "/predict",
                          {"inputs": [[[1.0, 2.0]]]})
    assert (code, body["outputs"]) == (200, [[[1.0, 2.0]]])
    assert eng.on_break is not None
    eng.supervisor.record_failure()            # trips at threshold 1
    assert srv._stopped_event.wait(timeout=30), "breaker drain never ran"
    assert eng.broken and eng.draining
    flat = serving.parse_exposition(open(path).read())
    assert flat['pdtpu_serving_requests_total{outcome="completed"}'] == 1
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        serving.serve("/no/such/model")
    with pytest.raises(ValueError, match="needs a BatchingEngine"):
        serving.ServingServer()


# ---- engine repairs ----

def test_engine_config_fields_and_weight_version(models):
    """LLMEngineConfig holds every field of JAX's but `observatory` (38
    of 39), in JAX's defaults; weight_version starts at "v0" and an
    empty one is refused at engine construction in both packages."""
    import dataclasses
    from paddle_tpu.serving import llm as jllm
    from paddle_tpu_torch.serving import llm as tllm
    jf = {f.name: f.default for f in dataclasses.fields(jllm.LLMEngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tllm.LLMEngineConfig)}
    assert len(jf) == 39 and len(tf) == 38
    assert set(jf) - set(tf) == {"observatory"} and set(tf) <= set(jf)
    assert {k: jf[k] for k in tf} == tf
    jm, tm = models
    for pkg, m in ((jllm, jm), (tllm, tm)):
        eng = pkg.LLMEngine(m, pkg.LLMEngineConfig(**CFG,
                                                   weight_version="v7"))
        assert eng.weight_version == "v7"
        with pytest.raises(ValueError, match="non-empty"):
            pkg.LLMEngine(m, pkg.LLMEngineConfig(**CFG, weight_version=""))
    assert issubclass(tllm.WeightSwapError, ValueError)


def test_evacuate_matches_jax(models):
    """evacuate() mid-run fails every queued and active request with the
    reason given, in both packages alike: the same count, exceptions,
    reject metrics, deploy_evacuate event and balanced pool; the engine
    then serves on, its next stream equal to JAX's."""
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    je, te = engine_pair(*models, CFG, jax_steps=JAX_STEPS)
    jfr().clear()
    tfr().clear()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 500, size=(n,)).astype(np.int32)
               for n in (5, 20, 9, 3, 12)]
    hs = [[e.submit(p, max_new_tokens=6) for p in prompts]
          for e in (je, te)]
    for _ in range(2):
        je.pump()
        te.pump()
    assert [e.evacuate("deploy_drain") for e in (je, te)] == [5, 5]
    for jh, th in zip(*hs):
        je_x, te_x = jh.future.exception(0), th.future.exception(0)
        assert type(te_x).__name__ == type(je_x).__name__ == \
            "RejectedError"
        assert te_x.reason == je_x.reason == "deploy_drain"
        assert str(te_x) == str(je_x)
        assert th.tokens_so_far() == jh.tokens_so_far()
    assert te.metrics.reject_reasons == je.metrics.reject_reasons == \
        {"deploy_drain": 5}
    ev = [[{k: v for k, v in e.items() if k not in ("t_mono", "t_wall",
                                                   "seq")}
           for e in fr().snapshot()["events"]
           if e["kind"] == "deploy_evacuate"] for fr in (jfr, tfr)]
    assert ev[1] == ev[0] == [{"kind": "deploy_evacuate", "engine": "llm",
                               "reason": "deploy_drain", "n": 5}]
    assert te.pool.active_slots() == 0 and te.pool.check_balance()
    assert not te.has_work() and te.evacuate() == 0
    after = [e.submit(prompts[0], max_new_tokens=4) for e in (je, te)]
    drain(je)
    drain(te)
    np.testing.assert_array_equal(after[1].result(0), after[0].result(0))
