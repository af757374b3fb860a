"""The port's rolling weight deploys (`serving/deploy.py`,
`obs/deploy_metrics.py`, `LLMEngine.replace_params`) against the JAX
package's (tests/test_deploy.py's contracts and tests/test_lora.py's
adapter rollout), on gpt2-tiny twins with bridged weights. Each package's
fleet runs on one SimClock, both pumped in lockstep with their
controllers, every request with the same rid in both.

- `replace_params` refuses what JAX's refuses (work in flight, another
  signature) and a few things only a torch state can get wrong (a
  missing name, a dtype, a device); a legal swap flushes the prefix cache.
  It rebinds: the prior tensors stay bit-equal and alive in the caller's
  dict, and passing them back restores the prior streams bit for bit.
  JAX's own swap has nothing to alias: its trees are immutable.
- A rolling deploy over a 3-replica fleet mid-decode: zero dropped
  streams, each equal to JAX's and to generate(), the same flight story
  and `pdtpu_deploy_*` and `pdtpu_router_*` exposition as JAX's.
- `deploy_bad_weights`: the canary fails on the first replica, the fleet
  rolls back, and a burst after the rollback equals the one before the
  deploy bit for bit. `swap_stall` gates the canary at the same instants
  as JAX's; version skew keeps a pinned stream off the other version,
  pending until one exists; a replica crash mid-rollout is skipped.
- `RouterServer`'s POST /deploy: 412 "no_manifest" for uncertified weights
  (as JAX's), 202 then a completed record, the new versions in /healthz
  and the deploy families on /metrics.
- `deploy_adapter`: an adapter rollout completes with JAX's record and
  streams, a NaN one rolls back on every replica it touched.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_port import (_port_twin, adapter_tree, drain,  # noqa: F401
                         engine_pair, fleet_pair, one_torch_thread,
                         tiny_models)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_slots=4, block_len=8, n_blocks=4, max_queue_depth=64)
JAX_STEPS = {}
EVENT_DROP = ("t_mono", "t_wall", "seq", "leaves")
DEPLOY_KINDS = {"deploy_started", "deploy_drain", "deploy_swap",
                "deploy_canary_pass", "deploy_canary_fail",
                "deploy_rollback", "deploy_rollback_done",
                "deploy_complete", "deploy_skip", "deploy_evacuate",
                "router_failover", "router_readmit", "weight_swap"}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def alt():
    """(JAX, port) gpt2-tiny of other weights: a real v2."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM
    paddle.seed(123)
    jd = GPTForCausalLM.from_preset("gpt2-tiny")
    return jd, _port_twin(jd, "gpt2-tiny")


@pytest.fixture(autouse=True)
def _clean_plans():
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


def _plans(spec):
    """Install the same global fault plan in both packages."""
    from paddle_tpu.utils.fault_injection import FaultPlan as JaxPlan
    from paddle_tpu.utils.fault_injection import set_global_plan as jset
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    from paddle_tpu_torch.utils.fault_injection import (
        set_global_plan as tset)
    jset(JaxPlan.from_spec(spec))
    tset(FaultPlan.from_spec(spec))


def _jax_params(jm):
    from paddle_tpu.models.generation import make_decoder_fns
    return make_decoder_fns(jm)[0]


def _publish(jm, tm, tmp_path, version):
    """The same weights published as a certified WeightSet by each
    package (JAX: its decoder params tree; the port: the model's
    state_dict)."""
    from paddle_tpu.checkpoint import WeightSet as JaxSet
    from paddle_tpu_torch.checkpoint import WeightSet
    return (JaxSet.publish(str(tmp_path / "jax"), version, _jax_params(jm)),
            WeightSet.publish(str(tmp_path / "port"), version,
                              dict(tm.state_dict())))


def _fleets(models, n=2, **kw):
    return fleet_pair(*models, kw.pop("cfg", CFG), n, jax_steps=JAX_STEPS,
                      **kw)


def _controllers(routers, **cfg):
    from paddle_tpu import serving as jserving
    from paddle_tpu_torch import serving as tserving
    cfg = {"watch_window_s": 0.05, **cfg}
    return [pkg.DeploymentController(r, pkg.DeployConfig(**cfg))
            for pkg, r in zip((jserving, tserving), routers)]


def _step(routers, ctrls=(), dt=0.01):
    for i, r in enumerate(routers):
        r.clock.advance(dt)
        r.pump()
        if ctrls:
            ctrls[i].pump()


def _drive(routers, ctrls=(), dt=0.01, max_steps=6000):
    """Router (and controller) pumps in lockstep until the rollouts
    settle and the traffic drains, at the same step in both packages."""
    steps = 0

    def busy(i):
        return routers[i].has_work() or (ctrls and ctrls[i].active())

    while busy(0) or busy(1):
        assert busy(0) == busy(1)
        _step(routers, ctrls, dt)
        steps += 1
        assert steps < max_steps, "deploy failed to converge"
    return steps


def _submit(routers, prompts, tag, **kw):
    return [tuple(r.submit(p, rid=f"{tag}{i}", **kw) for r in routers)
            for i, p in enumerate(prompts)]


def _prompts(seed, n, length=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, size=(length,)).astype(np.int32)
            for _ in range(n)]


def _reference(tm, prompts, new):
    from paddle_tpu_torch.models.generation import generate
    plen = prompts[0].size
    return generate(tm, np.stack(prompts), max_new_tokens=new).numpy()[
        :, plen:]


def _assert_streams(pairs, ref=None):
    for i, (jh, th) in enumerate(pairs):
        out = np.asarray(th.result(timeout=0))
        np.testing.assert_array_equal(out, np.asarray(jh.result(timeout=0)))
        if ref is not None:
            np.testing.assert_array_equal(out, ref[i])


def _events(kinds=DEPLOY_KINDS):
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    return [[{k: v for k, v in e.items() if k not in EVENT_DROP}
             for e in fr().snapshot()["events"] if e["kind"] in kinds]
            for fr in (jfr, tfr)]


def _assert_same(routers, ctrls):
    jr, tr = routers
    assert tr.metrics.snapshot() == jr.metrics.snapshot()
    assert tr.metrics.render() == jr.metrics.render()
    assert tr.healthz() == jr.healthz()
    if ctrls:
        assert ctrls[1].metrics.snapshot() == ctrls[0].metrics.snapshot()
        assert ctrls[1].metrics.render() == ctrls[0].metrics.render()
        assert ctrls[1].status() == ctrls[0].status()
    jev, tev = _events()
    assert tev == jev


def _burst(engines, prompts, new=6):
    """Each prompt through each engine (SimClock, drained): streams."""
    hs = [[e.submit(p, max_new_tokens=new) for p in prompts]
          for e in engines]
    for e in engines:
        drain(e)
    return [[np.asarray(h.result(0)) for h in row] for row in hs]


# ---- replace_params ----

def test_replace_params_guards_match_jax(models):
    """Refused with work in flight (the same message as JAX's) and for a
    reshaped leaf ("signature", the version unchanged); the port also
    refuses a missing name, another dtype, another device and a
    non-tensor. A legal swap advances the version, flushes the prefix
    cache with the pool balanced, and records weight_swap as JAX does."""
    from paddle_tpu_torch.serving import WeightSwapError
    je, te = engine_pair(*models, CFG, jax_steps=JAX_STEPS)
    jp, tp = je.params, te.params
    for e in (je, te):
        e.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
    errs = []
    for e, p in ((je, jp), (te, tp)):
        with pytest.raises(ValueError, match="work in flight") as exc:
            e.replace_params(p, "v2")
        errs.append((type(exc.value).__name__, str(exc.value)))
    assert errs[1] == errs[0]
    drain(je)
    drain(te)
    assert te.metrics.snapshot()["cached_blocks"] == \
        je.metrics.snapshot()["cached_blocks"] > 0

    name = max(tp, key=lambda k: tp[k].dim())
    bad = [{**tp, name: tp[name].reshape(-1)},
           {k: v for k, v in tp.items() if k != name},
           {**tp, name: tp[name].double()},
           {**tp, name: torch.empty(tp[name].shape, device="meta")},
           {**tp, name: tp[name].numpy()}]
    for b, word in zip(bad, ("signature", "structure", "signature",
                             "signature", "not a tensor")):
        with pytest.raises(WeightSwapError, match=word):
            te.replace_params(b, "v2")
    with pytest.raises(ValueError, match="non-empty"):
        te.replace_params(tp, "")
    assert te.weight_version == "v0"

    for e, p in ((je, jp), (te, tp)):
        e.replace_params(p, "v2")
        assert e.weight_version == "v2"
        assert e.pool.cached_blocks() == 0
        assert e.pool.check_balance()
    jev, tev = _events({"weight_swap"})
    assert tev == jev == [{"kind": "weight_swap", "engine": "llm",
                           "version": "v2", "prior": "v0",
                           "flushed_blocks": jev[0]["flushed_blocks"]}]
    assert jev[0]["flushed_blocks"] > 0


def test_swap_rebinds_and_rollback_restores_streams_bit_equal(models, alt):
    """A swap to other weights (v2) rebinds the model to v2's tensors and
    leaves the prior tensors untouched in the caller's dict; streams on
    v2 equal JAX's on v2 and a plain engine's; swapping the prior dict
    back restores the model's own tensors and streams bit-equal to those
    before the swap, in JAX too."""
    import copy
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    jm, tm = models
    ja, ta = alt
    je, te = engine_pair(jm, copy.deepcopy(tm), CFG, jax_steps=JAX_STEPS)
    prompts = _prompts(21, 3)
    before = _burst((je, te), prompts)
    np.testing.assert_array_equal(before[1], before[0])

    prior = {k: (v, v.clone()) for k, v in te.params.items()}
    new = {k: v.clone() for k, v in ta.state_dict().items()}
    jprior = je.params
    je.replace_params(_jax_params(ja), "v2")
    te.replace_params(new, "v2")
    now = te.params
    assert all(now[k].data_ptr() == new[k].data_ptr() for k in new)
    assert all(torch.equal(t, c) for t, c in prior.values())
    on_v2 = _burst((je, te), prompts)
    np.testing.assert_array_equal(on_v2[1], on_v2[0])
    plain = LLMEngine(ta, LLMEngineConfig(**CFG), clock=SimClock())
    np.testing.assert_array_equal(on_v2[1], _burst((plain,), prompts)[0])
    assert any(not np.array_equal(a, b) for a, b in zip(on_v2[1],
                                                        before[1]))

    je.replace_params(jprior, "v0")
    te.replace_params({k: t for k, (t, _) in prior.items()}, "v0")
    assert all(te.params[k].data_ptr() == t.data_ptr()
               for k, (t, _) in prior.items())
    after = _burst((je, te), prompts)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])
    assert all(torch.equal(new[k], v) for k, v in ta.state_dict().items())


# ---- rolling deploys ----

def test_rolling_deploy_zero_drops_bit_identical(models, tmp_path):
    """v0 -> v2 (the same weights, so streams stay comparable) across a
    3-replica fleet mid-decode: every stream equal to JAX's and to
    generate(), every replica on v2 and serving, the same flight story,
    deploy and router exposition and status as JAX's."""
    routers = _fleets(models, n=3)
    prompts = _prompts(7, 6)
    warm = _submit(routers, prompts, "w", max_new_tokens=10)
    _drive(routers)
    pairs = _submit(routers, prompts, "b", max_new_tokens=10)
    for _ in range(6):
        _step(routers)
    assert all(len(h.tokens_so_far()) > 0 for p in pairs for h in p)
    sets = _publish(*models, tmp_path, "v2")
    ctrls = _controllers(routers, settle_timeout_s=60.0)
    for c, ws in zip(ctrls, sets):
        c.start(ws)
    _drive(routers, ctrls)
    ref = _reference(models[1], prompts, 10)
    _assert_streams(warm, ref)
    _assert_streams(pairs, ref)
    for r in routers:
        assert [x.weight_version for x in r.replicas] == ["v2"] * 3
        assert all(x.deploy_state == "serving" for x in r.replicas)
        assert r.healthz()["status"] == "ok"
        assert r.metrics.snapshot()["rejected"] == 0
    _assert_same(routers, ctrls)
    jev, tev = _events({"deploy_swap", "deploy_complete"})
    assert [e["replica"] for e in tev if e["kind"] == "deploy_swap"] == \
        ["replica0", "replica1", "replica2"]
    snap = ctrls[1].metrics.snapshot()
    assert snap["deploys"] == {"started": 1, "completed": 1,
                               "rolled_back": 0}
    assert snap["swaps"] == 3 and snap["canaries"] == {"pass": 3, "fail": 0}


def test_bad_weights_rollback_restores_prior_streams(models, tmp_path):
    """deploy_bad_weights@0 NaN-poisons the certified load: the first
    replica's canary fails while it is out of placement, the fleet rolls
    back to v0 with every in-flight stream equal to generate(), and a
    burst after the rollback equals the burst before the deploy bit for
    bit (the prior tensors came back, not the NaN ones), in JAX too."""
    routers = _fleets(models)
    prompts = _prompts(11, 4)
    pre = _submit(routers, prompts, "p", max_new_tokens=10)
    _drive(routers)
    pairs = _submit(routers, prompts, "b", max_new_tokens=10)
    for _ in range(4):
        _step(routers)
    prior = [dict(x.engine.params) for x in routers[1].replicas]
    _plans("deploy_bad_weights@0")
    sets = _publish(*models, tmp_path, "v2")
    ctrls = _controllers(routers)
    for c, ws in zip(ctrls, sets):
        c.start(ws)
    _drive(routers, ctrls)
    ref = _reference(models[1], prompts, 10)
    _assert_streams(pre, ref)
    _assert_streams(pairs, ref)
    for r in routers:
        assert [x.weight_version for x in r.replicas] == ["v0", "v0"]
        assert all(x.deploy_state == "serving" for x in r.replicas)
    for x, p in zip(routers[1].replicas, prior):
        assert all(x.engine.params[k].data_ptr() == v.data_ptr()
                   for k, v in p.items())
    rec = ctrls[1].status()["history"][-1]
    assert rec["outcome"] == "rolled_back"
    assert rec["reason"] == "canary_fail:nonfinite_logits:prompt0"
    _assert_same(routers, ctrls)
    jev, tev = _events({"deploy_canary_fail", "deploy_rollback"})
    assert [e["kind"] for e in tev] == ["deploy_canary_fail",
                                        "deploy_rollback"]
    post = _submit(routers, prompts, "q", max_new_tokens=10)
    _drive(routers)
    _assert_streams(post, [np.asarray(t.result(0)) for _, t in pre])
    for r in routers:
        toks, finite = r.replicas[0].engine.canary_probe([1, 2, 3], 3)
        assert finite and len(toks) == 3


def test_swap_stall_gates_canary(models, tmp_path):
    """swap_stall@0:5.0: the new weights are in place at once, but the
    canary waits in canary_wait until the stall has passed, at the same
    instants as JAX's; the rollout then completes."""
    routers = _fleets(models)
    _plans("swap_stall@0:5.0")
    ctrls = _controllers(routers)
    for c, ws in zip(ctrls, _publish(*models, tmp_path, "v2")):
        c.start(ws)
    trail = ([], [])
    for i, c in enumerate(ctrls):
        c.pump()                     # drain replica0
        c.pump()                     # settle -> swap, the stall armed
    assert [r.replicas[0].deploy_state for r in routers] == ["swapping"] * 2
    assert [r.replicas[0].weight_version for r in routers] == ["v2"] * 2
    for k in range(14):
        for i, (r, c) in enumerate(zip(routers, ctrls)):
            r.clock.advance(0.2 if k < 10 else 1.0)
            c.pump()
            trail[i].append((round(r.clock.now(), 6), c.status()["phase"]))
    assert trail[1] == trail[0]
    assert [p for _, p in trail[1]][:10] == ["canary_wait"] * 10
    _drive(routers, ctrls)
    assert ctrls[1].status()["history"][-1]["outcome"] == "completed"
    _assert_same(routers, ctrls)
    from paddle_tpu_torch.utils.fault_injection import global_plan
    assert global_plan().log == ["swap_stall@0:5.0"]


def _manual_swap(routers, name, params, version):
    """Drive one idle replica of each fleet through drain, swap and
    readmission by hand (fixture setup, not the controller's path)."""
    for r, p in zip(routers, params):
        rep = r._replica_by_name(name)
        r.drain_replica(name)
        rep.swap(p, version)
        assert rep.swap_ready()
        r.readmit_replica(name)


def test_skew_failover_resumes_only_on_same_version_replica(models):
    """A v0-pinned stream losing its replica resumes on the busy v0
    survivor, never on the idle v2 replica, and equals generate()."""
    routers = _fleets(models, n=3)
    params = (_jax_params(models[0]),
              {k: v.clone() for k, v in models[1].state_dict().items()})
    _manual_swap(routers, "replica2", params, "v2")
    prompts = _prompts(13, 2)
    pairs = _submit(routers, prompts, "s", max_new_tokens=12)
    assert [[h._replica.name for h in p] for p in pairs] == \
        [["replica0"] * 2, ["replica1"] * 2]
    for _ in range(5):
        _step(routers)
    _plans("replica_crash@0")
    _drive(routers)
    assert [h._replica.name for h in pairs[0]] == ["replica1"] * 2
    _assert_streams(pairs, _reference(models[1], prompts, 12))
    assert [r.replicas[2].engine.metrics.snapshot()["completed"]
            for r in routers] == [0, 0]
    _assert_same(routers, ())


def test_skew_pending_until_same_version_replica_exists(models):
    """With the only v0 replica dead, the v0-pinned stream waits pending
    (never resumed on v2) and completes equal to generate() once a v0
    replica comes back."""
    routers = _fleets(models)
    params = (_jax_params(models[0]),
              {k: v.clone() for k, v in models[1].state_dict().items()})
    _manual_swap(routers, "replica1", params, "v2")
    prompt = _prompts(17, 1)
    pair = _submit(routers, prompt, "k", max_new_tokens=12)[0]
    for _ in range(5):
        _step(routers)
    _plans("replica_crash@0")
    for _ in range(50):
        _step(routers)
    for h in pair:
        assert h._replica is None and not h.future.done()
        assert h.weight_version == "v0"
    _manual_swap(routers, "replica1", params, "v0")
    _drive(routers)
    assert [h._replica.name for h in pair] == ["replica1"] * 2
    _assert_streams([pair], _reference(models[1], prompt, 12))
    _assert_same(routers, ())


def test_replica_crash_mid_rollout_is_skipped(models, tmp_path):
    """replica1 crashes while replica0 drains: its v0 streams fail over to
    the remaining v0 replica, the rollout skips it and completes on
    replica0 and replica2, every stream equal to generate(), as JAX's."""
    routers = _fleets(models, n=3)
    prompts = _prompts(19, 6)
    pairs = _submit(routers, prompts, "c", max_new_tokens=10)
    for _ in range(4):
        _step(routers)
    ctrls = _controllers(routers, settle_timeout_s=60.0)
    for c, ws in zip(ctrls, _publish(*models, tmp_path, "v2")):
        c.start(ws)
    _plans("replica_crash@1")
    _drive(routers, ctrls)
    _assert_streams(pairs, _reference(models[1], prompts, 10))
    rec = ctrls[1].status()["history"][-1]
    assert (rec["outcome"], rec["skipped"], rec["swapped"]) == \
        ("completed", ["replica1"], ["replica0", "replica2"])
    assert [x.weight_version for x in routers[1].replicas] == \
        ["v2", "v0", "v2"]
    _assert_same(routers, ctrls)


# ---- the HTTP face ----

def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=120) as r:
        return r.read().decode()


def test_router_server_deploy_http(models, tmp_path):
    """POST /deploy: 412 with reason "no_manifest" for an unpublished
    version, as JAX's RouterServer answers; 400 without a version; then
    202 "rolling", /debug/deploy converging to a completed record,
    /healthz's weight_versions all v2, and pdtpu_deploy_* on /metrics."""
    from paddle_tpu import serving as jserving
    from paddle_tpu_torch import serving as tserving
    jr, tr = _fleets(models, clocks=(jserving.MonotonicClock(),
                                     tserving.MonotonicClock()))
    servers = [jserving.RouterServer(jr).start(),
               tserving.RouterServer(tr).start()]
    bases = [f"http://127.0.0.1:{s.port}" for s in servers]
    try:
        refused = [_post(b, "/deploy", {"directory": str(tmp_path / "none"),
                                        "version": "v9"}) for b in bases]
        assert [c for c, _ in refused] == [412, 412]
        assert refused[1][1]["reason"] == refused[0][1]["reason"] == \
            "no_manifest"
        assert [_post(b, "/deploy", {"directory": "x"})[0]
                for b in bases] == [400, 400]
        _, ws = _publish(*models, tmp_path, "v2")
        code, st = _post(bases[1], "/deploy", {"directory": ws.directory,
                                               "version": "v2"})
        assert (code, st["state"]) == (202, "rolling")
        deadline = time.monotonic() + 120
        while True:
            st = json.loads(_get(bases[1], "/debug/deploy"))
            if st["state"] == "idle":
                break
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert st["history"][-1]["outcome"] == "completed"
        hz = json.loads(_get(bases[1], "/healthz"))
        assert hz["weight_versions"] == {"replica0": "v2", "replica1": "v2"}
        flat = tserving.parse_exposition(_get(bases[1], "/metrics"))
        assert flat['pdtpu_deploy_deploys_total{outcome="completed"}'] == 1
        assert flat['pdtpu_router_replica_weight_info'
                    '{replica="replica0",version="v2"}'] == 1
    finally:
        for s in servers:
            s.stop(drain=False)


# ---- adapter rollout ----

def test_deploy_adapter_rollout_and_rollback_match_jax(models, tmp_path):
    """deploy_adapter over armed fleets: a certified adapter registers on
    both replicas after each canary, with JAX's record and adapter
    streams; a NaN-poisoned push (deploy_bad_weights on the controller's
    second deploy) rolls the row back on the replica it reached, and the
    adapter's streams stay those of the first push."""
    from paddle_tpu.checkpoint import AdapterWeightSet as JaxSet
    from paddle_tpu_torch.checkpoint import AdapterWeightSet
    cfg = dict(CFG, max_adapters=2, lora_rank=4)
    routers = _fleets(models, cfg=cfg)
    tree = adapter_tree(models[1], 3)
    sets = [S.publish(str(tmp_path / d), "helpdesk-v1", tree,
                      r.replicas[0].engine.adapter_bank.signature)
            for S, d, r in ((JaxSet, "jax", routers[0]),
                            (AdapterWeightSet, "port", routers[1]))]
    ctrls = _controllers(routers)
    recs = [c.deploy_adapter(ws, adapter_id="helpdesk")
            for c, ws in zip(ctrls, sets)]
    assert recs[1] == recs[0]
    assert (recs[1]["outcome"], recs[1]["swapped"]) == \
        ("completed", ["replica0", "replica1"])
    prompts = _prompts(23, 2, 6)
    first = _submit(routers, prompts, "a", max_new_tokens=8,
                    adapter="helpdesk")
    _drive(routers)
    _assert_streams(first)
    base = _reference(models[1], prompts, 8)
    assert any(not np.array_equal(t.result(0), base[i])
               for i, (_, t) in enumerate(first))

    _plans("deploy_bad_weights@1")
    recs = [c.deploy_adapter(ws, adapter_id="helpdesk")
            for c, ws in zip(ctrls, sets)]
    assert recs[1] == recs[0]
    assert (recs[1]["outcome"], recs[1]["reason"]) == \
        ("rolled_back", "nonfinite_logits:replica0:prompt0")
    again = _submit(routers, prompts, "r", max_new_tokens=8,
                    adapter="helpdesk")
    _drive(routers)
    _assert_streams(again, [np.asarray(t.result(0)) for _, t in first])
    _assert_same(routers, ctrls)
    jev, tev = _events({"adapter_deploy_started", "adapter_deploy_complete",
                        "adapter_deploy_rollback", "adapter_rollback"})
    assert [{k: v for k, v in e.items() if k != "bank_version"}
            for e in tev] == \
        [{k: v for k, v in e.items() if k != "bank_version"} for e in jev]
