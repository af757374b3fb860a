"""The port's fleet router (`serving/router.py`, `RouterMetrics`) against
the JAX package's (tests/test_router.py's contracts and
tests/test_tiered.py's handoff ones), on gpt2-tiny twins with bridged
weights. Each package's fleet runs on one SimClock, both fleets pumped in
lockstep (`fleet_pair`), and every request carries the same rid in both.

- Placement (prefix affinity, then load, then index), the health words,
  `healthz()`, and `RouterMetrics` exposition byte for byte, for a random
  sequence of the same events and after the same fleet runs.
- `replica_crash`: the victims' streams resume on the survivor, equal to
  JAX's and to an uninterrupted `generate()`, with the same
  `router_failover` events in submit order. `replica_hang`: the watchdog
  strikes, quarantine and backoff ladder at the same instants. Door
  shedding under a degraded fleet.
- Prefill/decode handoff: greedy and seeded-sampled streams equal JAX's
  and a solo engine's, one-token prefills on the decode replica, a
  decode crash right after a handoff re-placing the staged KV; the
  `export_stream` payload (now with `weight_version`) and its
  `kv_export` event equal JAX's.
- `RouterServer`: the same status codes and bodies as JAX's for the same
  HTTP requests, and a live in-process fleet that loses a replica under
  HTTP traffic with zero dropped streams, read only once /healthz shows
  the replica quarantined (the JAX test reads "degraded", which can come
  before the quarantine: ROADMAP §3 item 12).
- `fleet_pair` jits the JAX engines' canary forwards, which the JAX engine
  runs eagerly (test_torch_deploy.py's rollouts probe them): on the canary
  prompts, with good and with NaN-poisoned weights, the jitted canary
  answers as the eager one.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_port import (fleet_pair, one_torch_thread,  # noqa: F401
                         share_jax_steps, tiny_models)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_slots=4, block_len=8, n_blocks=4, max_queue_depth=64)
JAX_STEPS = {}      # the JAX engines' unified step, compiled once
EVENT_DROP = ("t_mono", "t_wall", "seq", "ms")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(autouse=True)
def _clean_plans():
    """Replica clauses may key on the global plans; the flight recorders
    are process-global too. Neither leaks into the next test."""
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu.utils.fault_injection import set_global_plan as jset
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    from paddle_tpu_torch.utils.fault_injection import (
        set_global_plan as tset)
    for f in (jset, tset):
        f(None)
    jfr().clear()
    tfr().clear()
    yield
    for f in (jset, tset):
        f(None)


def _fleets(models, n=2, **kw):
    return fleet_pair(*models, kw.pop("cfg", CFG), n, jax_steps=JAX_STEPS,
                      **kw)


def _step(routers, dt=0.01):
    for r in routers:
        r.clock.advance(dt)
        r.pump()


def _drive(routers, dt=0.01, max_steps=2000):
    """Pump both fleets in lockstep until neither has work; they must
    run out of work at the same step."""
    steps = 0
    while any(r.has_work() for r in routers):
        assert len({r.has_work() for r in routers}) == 1
        _step(routers, dt)
        steps += 1
        assert steps < max_steps, "router failed to converge"
    return steps


def _submit(routers, prompts, tag, **kw):
    """The same requests, with the same rids, to both fleets: a list of
    (JAX handle, port handle)."""
    return [tuple(r.submit(p, rid=f"{tag}{i}", **kw) for r in routers)
            for i, p in enumerate(prompts)]


def _events(kinds):
    """Each package's flight events of `kinds`, without their times,
    sequence numbers and measured milliseconds."""
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    return [[{k: v for k, v in e.items() if k not in EVENT_DROP}
             for e in fr().snapshot()["events"] if e["kind"] in kinds]
            for fr in (jfr, tfr)]


def _reference(tm, prompts, new):
    """The port's uninterrupted one-shot greedy generate()."""
    from paddle_tpu_torch.models.generation import generate
    plen = prompts[0].size
    return generate(tm, np.stack(prompts), max_new_tokens=new).numpy()[
        :, plen:]


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, size=(length,)).astype(np.int32)
            for _ in range(n)]


def _assert_streams(pairs, ref=None):
    for i, (jh, th) in enumerate(pairs):
        out = np.asarray(th.result(timeout=0))
        np.testing.assert_array_equal(out, np.asarray(jh.result(timeout=0)))
        if ref is not None:
            np.testing.assert_array_equal(out, ref[i])
        assert th.failovers == jh.failovers


def _assert_metrics_equal(routers):
    jr, tr = routers
    assert tr.metrics.snapshot() == jr.metrics.snapshot()
    assert tr.metrics.render() == jr.metrics.render()
    assert tr.healthz() == jr.healthz()


# ---- placement, health, metrics ----

def test_routing_prefix_affinity_then_load(models):
    """The second admission of a prefix lands on the replica caching it;
    a cold prompt beside a busier replica goes to the lighter one; the
    metrics and healthz equal JAX's."""
    routers = _fleets(models)
    shared, cold = _prompts(1, 2, 16)
    picks = []
    for tag, p in (("a", shared), ("b", shared), ("c", shared),
                   ("d", cold)):
        pair = _submit(routers, [p], tag, max_new_tokens=4)[0]
        picks.append(tuple(h._replica.name for h in pair))
        if tag in "ab":
            _drive(routers)
        if tag == "a":
            assert [r.replicas[0].prefix_probe(shared) for r in routers] \
                == [16, 16]
    assert [t for _, t in picks] == [j for j, _ in picks] == \
        ["replica0", "replica0", "replica0", "replica1"]
    _drive(routers)
    _assert_metrics_equal(routers)
    assert routers[1].metrics.snapshot()["affinity_hit_rate"] == 0.5


def test_router_metrics_exposition_byte_equal():
    """A random sequence of router events, drawn from a seed, into both
    packages' RouterMetrics: snapshot and exposition text equal."""
    from paddle_tpu.serving.metrics import RouterMetrics as Jax
    from paddle_tpu_torch.serving import parse_exposition
    from paddle_tpu_torch.serving.metrics import RouterMetrics

    rng = np.random.RandomState(0)
    ms = [Jax(), RouterMetrics()]
    names = ["replica0", "replica1", "replica2"]
    words = ["ok", "quarantined", "crashed", "draining", "canary"]
    reasons = ["shed", "fleet_unavailable", "queue_full", "version_retired"]
    for _ in range(400):
        op = rng.randint(11)
        rep = names[rng.randint(3)]
        seed = rng.randint(1 << 30)
        for m in ms:
            st = np.random.RandomState(seed)
            if op == 0:
                m.on_submit()
            elif op == 1:
                m.on_route(rep, prefix_hit=bool(st.randint(2)))
            elif op == 2:
                m.on_reject(reasons[st.randint(4)])
            elif op == 3:
                m.on_complete()
            elif op == 4:
                m.on_fail()
            elif op == 5:
                m.set_replica(rep, words[st.randint(5)], st.randint(999),
                              weight_version=f"v{st.randint(3)}",
                              role=("prefill", "decode", "mixed")[
                                  st.randint(3)])
            elif op == 6:
                m.on_handoff(rep, names[0], float(st.rand() * 40))
            elif op == 7:
                m.on_handoff_failed()
            elif op == 8:
                m.on_quarantine(rep)
            elif op == 9:
                m.on_readmit(rep)
            else:
                m.on_failover(rep, st.randint(5))
    assert ms[1].snapshot() == ms[0].snapshot()
    assert ms[1].render() == ms[0].render()
    assert ms[1].handoff_quantile_ms(0.99) == ms[0].handoff_quantile_ms(0.99)
    flat = parse_exposition(ms[1].render())
    assert flat["pdtpu_router_handoff_ms{quantile=\"0.99\"}"] > 0


# ---- zero dropped streams across a replica loss ----

def test_crash_failover_resumes_bit_identical_mid_decode(models):
    """replica_crash@0 after every stream has emitted: the two victims
    resume on replica1, equal to JAX's and to generate(), with the same
    router_failover events in submit order, the same quarantine and
    metrics, and a flight dump of the failover."""
    routers = _fleets(models, fault_plan="")
    prompts = _prompts(2, 4, 6)
    pairs = _submit(routers, prompts, "s", max_new_tokens=12)
    assert [[h._replica.name for h in p] for p in pairs] == \
        [["replica0"] * 2, ["replica1"] * 2] * 2
    for _ in range(6):
        _step(routers)
    assert all(len(h.tokens_so_far()) > 0 for p in pairs for h in p)
    assert [len(th.tokens_so_far()) for _, th in pairs] == \
        [len(jh.tokens_so_far()) for jh, _ in pairs]
    for r in routers:
        r.plan.add("replica_crash", 0)
    _drive(routers)
    _assert_streams(pairs, _reference(models[1], prompts, 12))
    assert [th.failovers for _, th in pairs] == [1, 0, 1, 0]
    jev, tev = _events({"router_failover", "router_quarantine"})
    assert tev == jev
    assert [e["rid"] for e in tev if e["kind"] == "router_failover"] == \
        ["s0", "s2"]
    _assert_metrics_equal(routers)
    assert routers[1].healthz()["replicas"]["replica0"] == "quarantined"
    assert routers[1].plan.log == routers[0].plan.log


def test_hang_quarantine_backoff_readmission_ladder(models):
    """replica_hang@0:3.0: the watchdog's strikes, the quarantine, every
    re-admission probe of the backoff ladder and the final re-admission
    happen at the same SimClock instants as JAX's; the stream fails over
    and equals generate()."""
    rc = dict(hung_timeout_s=0.05, quarantine_threshold=2,
              backoff_base_s=0.2, backoff_max_s=5.0)
    routers = _fleets(models, fault_plan="replica_hang@0:3.0",
                      router_cfg=rc)
    prompt = _prompts(3, 1, 6)
    pairs = _submit(routers, prompt, "h", max_new_tokens=6)
    assert [h._replica.name for h in pairs[0]] == ["replica0"] * 2

    def ladder(r):
        st = r._state["replica0"]
        return (round(r.clock.now(), 6), st.quarantined, st.failures,
                st.backoff_level, round(st.next_probe, 6))

    trail = ([], [])

    def step(dt):
        _step(routers, dt)
        for i, r in enumerate(routers):
            trail[i].append(ladder(r))

    step(0.01)                          # arms the hang: frozen forward
    while not routers[1]._state["replica0"].quarantined:
        step(0.1)
        assert len(trail[1]) <= 5
    assert len(trail[1]) - 1 == rc["quarantine_threshold"]
    while routers[1].has_work():        # the stream finishes on replica1
        step(0.05)
    _assert_streams(pairs, _reference(models[1], prompt, 6))
    assert pairs[0][1].failovers == 1
    while routers[1].clock.now() < 2.5:     # the hang persists: the
        step(0.1)                           # probes back off
    assert routers[1]._state["replica0"].backoff_level >= 2
    while routers[1]._state["replica0"].quarantined:
        step(0.5)
        assert routers[1].clock.now() < 20.0
    assert trail[1] == trail[0]
    snap = routers[1].metrics.snapshot()
    assert snap["quarantines"] == {"replica0": 1}
    assert snap["readmissions"] == {"replica0": 1}
    _assert_metrics_equal(routers)


def test_fleet_brownout_shed_confined_to_best_effort(models):
    """Half the fleet down: best_effort is shed at the router's door
    (retryable, with a Retry-After hint) while interactive streams still
    equal generate(); the whole fleet down: fleet_unavailable. Both as
    JAX raises them."""
    routers = _fleets(models, fault_plan="replica_crash@0")
    prompt = _prompts(4, 1, 6)
    first = _submit(routers, prompt, "i", max_new_tokens=6,
                    slo="interactive")
    _step(routers)
    assert all(r.replicas[0].crashed for r in routers)

    def rejects(**kw):
        out = []
        for r in routers:
            with pytest.raises(Exception) as exc:
                r.submit(prompt[0], **kw)
            out.append((type(exc.value).__name__, exc.value.reason,
                        exc.value.retry_after_s))
        assert out[1] == out[0]
        return out[1]

    assert rejects(max_new_tokens=6, slo="best_effort") == \
        ("RejectedError", "shed", 1.0)
    second = _submit(routers, prompt, "j", max_new_tokens=6,
                     slo="interactive")
    _drive(routers)
    ref = _reference(models[1], prompt, 6)
    _assert_streams(first, ref)
    _assert_streams(second, ref)
    for r in routers:
        r.replicas[1].crash()
        r.pump()
    assert [r.healthz()["status"] for r in routers] == ["unavailable"] * 2
    assert rejects(max_new_tokens=2)[1] == "fleet_unavailable"
    _assert_metrics_equal(routers)


# ---- prefill/decode handoff ----

def test_handoff_prefill_to_decode_greedy_and_sampled(models):
    """Roles prefill and decode: every stream is admitted on the prefill
    replica, handed off after its first token and decoded on the decode
    replica with a one-token prefill; greedy streams equal generate(), a
    seeded sampled stream a solo engine's, logprobs stitched; the
    handoff counters, router_handoff and kv_export events, healthz roles
    and metrics equal JAX's."""
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import (LLMEngine, LLMEngineConfig,
                                              SamplingParams)
    routers = _fleets(models, roles=["prefill", "decode"])
    prompts = _prompts(14, 3, 9)
    pairs = _submit(routers, prompts, "g", max_new_tokens=10,
                    logprobs=True)
    assert all(h._replica.name == "replica0" for p in pairs for h in p)
    sp_args = dict(temperature=0.9, top_k=50, top_p=0.95, seed=77)
    from paddle_tpu.serving.llm.sampling import SamplingParams as JaxSP
    sampled = [(routers[0].submit(np.arange(5, 17, dtype=np.int32),
                                  max_new_tokens=12, rid="x",
                                  sampling=JaxSP(**sp_args)),
                routers[1].submit(np.arange(5, 17, dtype=np.int32),
                                  max_new_tokens=12, rid="x",
                                  sampling=SamplingParams(**sp_args)))]
    _drive(routers)
    _assert_streams(pairs, _reference(models[1], prompts, 10))
    for jh, th in pairs:
        assert th._replica.name == "replica1"
        lt, lj = th.logprobs_so_far(), jh.logprobs_so_far()
        assert len(lt) == 10 and None not in lt
        np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=0)
    solo = LLMEngine(models[1], LLMEngineConfig(**CFG), clock=SimClock())
    hs = solo.submit(np.arange(5, 17, dtype=np.int32), max_new_tokens=12,
                     sampling=SamplingParams(**sp_args))
    while solo.has_work():
        solo.pump()
    _assert_streams(sampled, [hs.result(0)])
    snap = routers[1].metrics.snapshot()
    assert snap["handoffs"] == 4 and snap["handoffs_failed"] == 0
    assert [r.replicas[1].engine.kv_import_tokens for r in routers] == \
        [3 * 9 + 12] * 2
    jev, tev = _events({"router_handoff", "kv_export"})
    assert tev == jev
    assert len([e for e in tev if e["kind"] == "kv_export"]) == 4
    assert routers[1].healthz()["roles"] == {"replica0": "prefill",
                                             "replica1": "decode"}
    # the handoff quantile is a router-clock span: JAX's and the port's
    # are the same SimClock instants
    assert routers[1].metrics.handoff_quantile_ms(0.99) == \
        routers[0].metrics.handoff_quantile_ms(0.99)
    _assert_metrics_equal(routers)
    for r in routers:
        for rep in r.replicas:
            assert rep.engine.pool.check_balance()


def test_decode_crash_after_handoff_reuses_staged_kv(models):
    """Roles prefill, decode, decode: the decode replica holding a
    freshly handed-off stream crashes before it emits; the stream is
    re-placed with the SAME staged KV on the other decode replica (a
    one-token prefill, no re-prefill) and equals generate()."""
    routers = _fleets(models, n=3, roles=["prefill", "decode", "decode"])
    prompt = _prompts(15, 1, 9)
    pair = _submit(routers, prompt, "k", max_new_tokens=10)[0]
    steps = 0
    while routers[1].metrics.snapshot()["handoffs"] == 0:
        _step(routers)
        steps += 1
        assert steps < 200
    assert [h._replica.name for h in pair] == ["replica1"] * 2
    emitted = pair[1]._prefix.size
    assert emitted == pair[0]._prefix.size >= 1
    for h in pair:
        h._replica.crash()
    _drive(routers)
    _assert_streams([pair], _reference(models[1], prompt, 10))
    assert [r.replicas[2].engine.kv_import_tokens for r in routers] == \
        [prompt[0].size + emitted - 1] * 2
    _assert_metrics_equal(routers)


def test_export_stream_payload_matches_jax(models):
    """The engine repair the handoff needs: export_stream's payload has
    JAX's keys in JAX's order, weight_version among them, the same lane,
    KV row length and (within fp32 rounding) KV, and a kv_export event
    like JAX's."""
    jr, tr = _fleets(models, n=1)
    je, te = jr.replicas[0].engine, tr.replicas[0].engine
    prompt = _prompts(16, 1, 11)[0]
    for e in (je, te):
        e.submit(prompt, max_new_tokens=8, rid="e0")
    for _ in range(3):
        je.pump()
        te.pump()
    jp, tp = je.export_stream("e0"), te.export_stream("e0")
    assert list(tp) == list(jp)
    assert tp["weight_version"] == jp["weight_version"] == "v0"
    assert tp["lane"] == jp["lane"] and tp["emitted"] == jp["emitted"]
    np.testing.assert_array_equal(tp["prompt"], jp["prompt"])
    assert tp["kv_row"]["length"] == jp["kv_row"]["length"] == 13
    for (tk, tv), (jk, jv) in zip(tp["kv_row"]["layers"],
                                  jp["kv_row"]["layers"]):
        np.testing.assert_allclose(np.asarray(tk), np.asarray(jk),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.asarray(tv), np.asarray(jv),
                                   atol=1e-4, rtol=0)
    jev, tev = _events({"kv_export"})
    assert tev == jev == [{"kind": "kv_export", "engine": "llm",
                           "rid": "e0", "tokens": 13, "emitted": 3}]
    assert te.pool.check_balance()


# ---- the JAX fleets' canary ----

def test_jitted_jax_canary_equals_eager(models):
    """The JAX canary as fleet_pair runs it (its forwards jitted) gives
    the eager canary's tokens and finite verdict on DeployConfig's canary
    prompts, and the same non-finite verdict on NaN-poisoned weights."""
    from paddle_tpu import serving as jserving
    from paddle_tpu.serving.deploy import _nan_poison
    jm, _ = models
    eager, jitted = (jserving.LLMEngine(jm, jserving.LLMEngineConfig(**CFG),
                                        clock=jserving.SimClock())
                     for _ in range(2))
    share_jax_steps(jitted, jm, JAX_STEPS, canary=True)
    dc = jserving.DeployConfig()

    def probes(e):
        return [e.canary_probe(p, dc.canary_max_new_tokens)
                for p in dc.canary_prompts]

    want = probes(eager)
    got = probes(jitted)
    assert [f for _, f in got] == [f for _, f in want] == [True, True]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for e in (eager, jitted):
        e.replace_params(_nan_poison(e.params), "bad")
    assert [f for _, f in probes(jitted)] == [f for _, f in probes(eager)] \
        == [False, False]


# ---- the HTTP face ----

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


def test_router_server_codes_and_bodies_match_jax(models):
    """The same requests to both packages' RouterServer over live fleets:
    200 with equal tokens (failovers 0, logprobs within 1e-4), 400 on a
    malformed X-Tenant-Id, slo or logprobs, 404 on an unknown route,
    /healthz and /debug/deploy alike, then, with every replica crashed,
    429 fleet_unavailable with Retry-After 1 and a 503 healthz."""
    from paddle_tpu import serving as jserving
    from paddle_tpu_torch import serving as tserving
    jr, tr = fleet_pair(*models, CFG, 2, jax_steps=JAX_STEPS,
                        clocks=(jserving.MonotonicClock(),
                                tserving.MonotonicClock()))
    servers = [jserving.RouterServer(jr).start(),
               tserving.RouterServer(tr).start()]
    bases = [f"http://127.0.0.1:{s.port}" for s in servers]
    try:
        cases = [
            ("/generate", {"input_ids": [5, 6, 7, 8], "max_new_tokens": 4,
                           "logprobs": True}, {"X-Tenant-Id": "acme.1"}),
            ("/generate", {"input_ids": [5, 6, 7]}, {"X-Tenant-Id": "-x"}),
            ("/generate", {"input_ids": [5], "slo": "gold"}, None),
            ("/generate", {"input_ids": [5], "logprobs": 1}, None),
            ("/generate", {"input_ids": []}, None),
            ("/generate", {"prompt": [5]}, None),
            ("/nothing", {"input_ids": [5]}, None),
            ("/healthz", None, None),
            ("/debug/deploy", None, None),
        ]
        got = []
        for base in bases:
            got.append([_http(base, p, b, h) for p, b, h in cases])
        for (jc, jb, jra), (tc, tb, tra) in zip(*got):
            assert (tc, tra) == (jc, jra)
            if isinstance(jb, dict) and "tokens" in jb:
                assert tb["tokens"] == jb["tokens"]
                assert tb["failovers"] == jb["failovers"] == 0
                np.testing.assert_allclose(tb["logprobs"], jb["logprobs"],
                                           atol=1e-4, rtol=0)
            elif isinstance(jb, dict) and "error" in jb:
                assert tb["error"].split(":")[0] == jb["error"].split(":")[0]
            else:
                assert tb == jb
        assert [c for c, _, _ in got[1]] == [200, 400, 400, 400, 400, 400,
                                             404, 200, 200]
        for r in (jr, tr):
            for rep in r.replicas:
                rep.crash()
        deadline = time.monotonic() + 30
        while any(r.healthz()["quarantined"] != ["replica0", "replica1"]
                  for r in (jr, tr)):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        tail = [[_http(b, "/generate", {"input_ids": [5]}),
                 _http(b, "/healthz")] for b in bases]
        assert tail[1] == tail[0]
        (code, body, retry), (hcode, _, _) = tail[1]
        assert (code, body["reason"], retry, hcode) == \
            (429, "fleet_unavailable", "1", 503)
    finally:
        for s in servers:
            s.stop(drain=False)


def test_live_router_server_replica_kill_zero_dropped(models):
    """A live in-process fleet of two replicas behind the port's
    RouterServer: four HTTP clients send requests; replica_crash@0 is
    armed once traffic flows; the clients keep going until /healthz reads
    replica0 "quarantined" (waited for, never assumed from "degraded").
    Every request returns 200 with its full stream, equal to generate();
    the final metrics reconcile: completions equal the 200s, resumed
    streams equal the per-response failovers, one quarantine."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    tm = models[1]
    plan = FaultPlan.from_spec("")
    _, router = fleet_pair(*models, CFG, 2, jax_steps=JAX_STEPS,
                           clocks=(None, serving.MonotonicClock()))
    for r in router.replicas:
        r._fault_plan = plan
    server = serving.RouterServer(router).start()
    base = f"http://127.0.0.1:{server.port}"
    results, lock, stop = [], threading.Lock(), threading.Event()

    def client(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            prompt = rng.randint(1, 500, size=(5,)).tolist()
            code, body, _ = _http(base, "/generate",
                                  {"input_ids": prompt,
                                   "max_new_tokens": 8})
            with lock:
                results.append((prompt, code, body))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while len(results) < 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        plan.add("replica_crash", 0)
        while True:
            _, health, _ = _http(base, "/healthz")
            if health["replicas"]["replica0"] == "quarantined":
                break
            assert time.monotonic() < deadline, health
            time.sleep(0.02)
        n_at_kill = len(results)
        while len(results) < n_at_kill + 4:     # traffic after the kill
            assert time.monotonic() < deadline
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert health["status"] == "degraded"
        assert health["replicas"]["replica1"] == "ok"
        assert all(code == 200 for _, code, _ in results), results
        for prompt, _, body in results:
            ref = generate(tm, np.asarray([prompt], np.int32),
                           max_new_tokens=8).numpy()[0, 5:]
            assert body["tokens"] == ref.tolist()
        _, text, _ = _http(base, "/metrics")
        flat = serving.parse_exposition(text)
        assert flat['pdtpu_router_replica_up{replica="replica0"}'] == 0
        assert flat['pdtpu_router_quarantines_total{replica="replica0"}'] \
            == 1
    finally:
        stop.set()
        server.stop()
    flat = serving.parse_exposition(router.metrics.render())
    assert flat['pdtpu_router_requests_total{outcome="completed"}'] == \
        len(results)
    assert flat['pdtpu_router_requests_total{outcome="failed"}'] == 0
    assert flat["pdtpu_router_resumed_streams_total"] == \
        sum(body["failovers"] for _, _, body in results)
    assert plan.log == ["replica_crash@0"]
