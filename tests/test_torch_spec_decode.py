"""Speculative decoding in the port's `LLMEngine` against the JAX engine
(tests/test_spec_decode.py's contracts, and tests/test_sampling.py's two
spec ones), on gpt2-tiny twins with bridged weights, on SimClocks. The
draft is the target itself (every window accepts) or a second bridged
gpt2-tiny drawn from another seed (most windows reject).

- Streams equal plain decode's on the port and the JAX engine's, greedy,
  seeded-sampled and constrained; the same decode iterations, spec
  counters, metric families, draft-quarantine outcomes, flight events and
  ledger economics (draft positions, drafted, accepted, token
  efficiency); both pools balanced. A self-draft run takes at most half
  of plain decode's iterations.
- EOS inside a window, the capacity edge, a warm hit on both prefix
  caches, a handoff (`export_stream`) in the middle of a window, an
  adapter row speculating beside a base row.
- `make_verify_fn`'s tokens equal JAX's; the draft pool's `rewind_length`
  and the ledger's draft booking equal JAX's.

Then what the JAX engine cannot show, because its draft dispatch is
functional:
- a draft blame probe runs at the row's committed draft length and
  leaves its committed draft KV bit-equal; with JAX's position-0
  addressing the same probe overwrites it;
- a draft attempt abandoned by the watchdog writes nothing into the
  draft slabs once revoked; with the fence's check a no-op it does.
"""
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import (_port_twin, adapter_tree,  # noqa: F401
                         armed_engine_pair, drain, engine_pair,
                         one_torch_thread, tiny_models)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_slots=2, block_len=8, n_blocks=4, max_queue_depth=64)
JAX_STEPS = {}      # the JAX engines' executables, compiled once a shape
SPEC_KEYS = ("spec_windows", "spec_drafted", "spec_accepted",
             "spec_accept_rate", "spec_draft_quarantines", "completed",
             "failed", "quarantined", "tokens_out", "decode_steps",
             "sampled_tokens", "constrained_tokens")
EVENT_DROP = ("t_mono", "t_wall", "seq", "rid", "error")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def alt():
    """(JAX, port) gpt2-tiny of other weights: a draft whose proposals
    the target mostly rejects."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM
    paddle.seed(123)
    jd = GPTForCausalLM.from_preset("gpt2-tiny")
    return jd, _port_twin(jd, "gpt2-tiny")


def _pair(models, draft, **over):
    return engine_pair(*models, {**CFG, **over}, jax_steps=JAX_STEPS,
                       drafts=draft)


def _plain(models, **over):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    return LLMEngine(models[1], LLMEngineConfig(**{**CFG, **over}),
                     clock=SimClock())


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, size=(n,)).astype(np.int32) for n in lens]


def _run(eng, prompts, staggered=False, **kw):
    hs = []
    for p in prompts:
        hs.append(eng.submit(p, **kw))
        if staggered:
            eng.pump()
    drain(eng)
    return hs


def _sp(pkg, **kw):
    if pkg == "jax":
        from paddle_tpu.serving.llm.sampling import SamplingParams
    else:
        from paddle_tpu_torch.serving.llm import SamplingParams
    return SamplingParams(**kw)


def assert_spec_equal(je, te, jh, th):
    """Equal streams (and logprobs within 1e-4), decode iterations, spec
    counters, metric keys, pool and draft-pool ledgers; both drained and
    balanced."""
    for a, b in zip(jh, th):
        assert b.future.done() and a.future.done()
        np.testing.assert_array_equal(b.tokens_so_far(), a.tokens_so_far())
        lj, lt = a.logprobs_so_far(), b.logprobs_so_far()
        if lj and lj[0] is not None:
            np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=0)
    for attr in ("decode_iterations", "prefill_tokens", "spec_windows",
                 "spec_drafted", "spec_accepted", "_spec_disabled",
                 "_dispatch_idx"):
        assert getattr(te, attr) == getattr(je, attr), attr
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for k in SPEC_KEYS:
        assert ts[k] == js[k], (k, js[k], ts[k])
    for tp, jp in ((te.pool, je.pool), (te.draft_pool, je.draft_pool)):
        assert tp.stats == jp.stats
        assert tp.check_balance() and jp.check_balance()
        assert tp.active_slots() == 0
    assert te.supervisor.snapshot() == je.supervisor.snapshot()


def _streams_equal(hs, ref):
    return all(np.array_equal(h.result(0), r.result(0))
               for h, r in zip(hs, ref))


# ---- the acceptance contract ----

def test_self_draft_matches_jax_in_half_the_iterations(models):
    prompts = _prompts(0, (6, 6, 6, 6))
    plain = _plain(models)
    ref = _run(plain, prompts, staggered=True, max_new_tokens=16)
    je, te = _pair(models, models)
    jh = _run(je, prompts, staggered=True, max_new_tokens=16)
    th = _run(te, prompts, staggered=True, max_new_tokens=16)
    assert_spec_equal(je, te, jh, th)
    assert _streams_equal(th, ref)
    snap = te.metrics.snapshot()
    assert snap["spec_accept_rate"] == 1.0
    assert snap["spec_windows"] == te.spec_windows > 0
    assert te.decode_iterations <= 0.5 * plain.decode_iterations


def test_mismatched_draft_matches_jax(models, alt):
    prompts = _prompts(7, (4, 7, 11))
    ref = _run(_plain(models), prompts, max_new_tokens=12)
    je, te = _pair(models, alt)
    jh = _run(je, prompts, max_new_tokens=12, logprobs=True)
    th = _run(te, prompts, max_new_tokens=12, logprobs=True)
    assert_spec_equal(je, te, jh, th)
    assert _streams_equal(th, ref)
    snap = te.metrics.snapshot()
    assert snap["spec_windows"] > 0
    assert snap["spec_accepted"] < snap["spec_drafted"]


def test_eos_inside_window_truncates_exactly(models):
    prompt = np.arange(1, 9, dtype=np.int32)
    ref = _run(_plain(models, num_slots=1), [prompt],
               max_new_tokens=12)[0].result(0)
    eos = int(ref[2])
    j = int(np.argmax(ref == eos))
    je, te = _pair(models, models, num_slots=1)
    jh = _run(je, [prompt], max_new_tokens=12, eos_token_id=eos)
    th = _run(te, [prompt], max_new_tokens=12, eos_token_id=eos)
    assert_spec_equal(je, te, jh, th)
    np.testing.assert_array_equal(th[0].result(0), ref[:j + 1])


def test_capacity_edge_degrades_to_plain_decode(models):
    prompt = np.arange(1, 7, dtype=np.int32)          # 6 + 6 == capacity
    over = dict(num_slots=1, block_len=4, n_blocks=3)
    ref = _run(_plain(models, **over), [prompt], max_new_tokens=6)
    je, te = _pair(models, models, **over)
    assert te.pool.capacity == 12
    jh = _run(je, [prompt], max_new_tokens=6)
    th = _run(te, [prompt], max_new_tokens=6)
    assert_spec_equal(je, te, jh, th)
    assert _streams_equal(th, ref)
    assert te.spec_windows >= 1


def test_prefix_cache_warm_hit_on_both_caches(models):
    rng = np.random.RandomState(11)
    shared = rng.randint(1, 500, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, 500, size=(4,))
                               .astype(np.int32)]) for _ in range(2)]
    je, te = _pair(models, models)
    assert te.draft_prefix_cache.snapshot()["name"] == "draft"
    jh = [h for p in prompts for h in _run(je, [p], max_new_tokens=8)]
    th = [h for p in prompts for h in _run(te, [p], max_new_tokens=8)]
    assert_spec_equal(je, te, jh, th)
    assert te.draft_prefix_cache.snapshot() \
        == je.draft_prefix_cache.snapshot()
    assert te.draft_prefix_cache.snapshot()["hits"] >= 1
    assert te.metrics.snapshot()["prefix_hits"] >= 1
    assert te.draft_pool.cached == je.draft_pool.cached


@pytest.mark.parametrize("seed", [None, 4242])
def test_handoff_mid_window_continues_the_stream(models, seed):
    """`export_stream` between the draft phase and the verify (as another
    thread may call it), with the draft run K+1 tokens ahead of the
    stream: the payload carries committed tokens only, both rows are
    freed, and a spec-armed receiver continues the stream as the JAX pair
    does and as the uninterrupted plain run emits it."""
    prompt = np.arange(5, 17, dtype=np.int32)
    knobs = None if seed is None else dict(temperature=0.9, top_k=50,
                                           top_p=0.95, seed=seed)
    ref = _run(_plain(models), [prompt], max_new_tokens=14,
               sampling=knobs and _sp("port", **knobs))[0].result(0)
    K = 4                           # LLMEngineConfig().spec_k
    streams = []
    for pkg, (src, dst) in zip(("jax", "port"),
                               zip(_pair(models, models),
                                   _pair(models, models))):
        sp = knobs and _sp(pkg, **knobs)
        h = src.submit(prompt, max_new_tokens=14, sampling=sp, rid="s")
        src.pump()                  # prefill: the first token
        box = {}
        phase = src._draft_phase

        def draft_then_export(phase=phase, src=src, box=box):
            spec = phase()
            box["dlen"] = int(src.draft_pool.lengths[0])
            box["pay"] = src.export_stream("s")
            return spec

        src._draft_phase = draft_then_export
        src.pump()
        pay = box["pay"]
        emitted = pay["emitted"]
        assert len(emitted) == 1 and src.spec_windows == 0
        assert box["dlen"] == len(prompt) + K + 1
        assert pay["kv_row"]["length"] == len(prompt)
        assert src.draft_pool.active_slots() == 0
        assert src.draft_pool.check_balance() and src.pool.check_balance()
        h2 = dst.submit(np.concatenate([prompt, emitted]).astype(np.int32),
                        max_new_tokens=14 - len(emitted), sampling=sp,
                        sample_offset=len(emitted), kv_row=pay["kv_row"],
                        lane=pay["lane"])
        drain(dst)
        assert not h.future.done() and dst.spec_windows > 0
        assert dst.draft_pool.check_balance()
        streams.append(list(emitted) + list(h2.result(0)))
    assert streams[1] == streams[0] == list(ref)


# ---- the pool and ledger primitives ----

def test_rewind_length_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.serving.llm import SlotPagedKVPool as JaxPool
    from paddle_tpu_torch.serving.llm import SlotPagedKVPool

    pools = [
        JaxPool(lambda b, n: [(jnp.zeros((b, 2, n, 3)),) * 2], 2, 4, 3),
        SlotPagedKVPool(lambda b, n: [(torch.zeros(b, 2, n, 3),) * 2],
                        2, 4, 3)]
    for p in pools:
        s = p.allocate(12)
        p.set_length(s, 10)
        p.rewind_length(s, 5)
        p.rewind_length(s, 5)
        with pytest.raises(ValueError, match="shrink"):
            p.rewind_length(s, 9)
        p.set_length(s, 9)
        assert len(p.block_table[s]) == 3
        p.free(s)
        p.check_balance()
    assert pools[1].stats == pools[0].stats


def test_ledger_books_draft_compute_as_jax():
    from paddle_tpu.obs.serving_ledger import ServingLedger as JaxLedger
    from paddle_tpu_torch.obs.serving_ledger import ServingLedger
    snaps = []
    for cls in (JaxLedger, ServingLedger):
        t = [0.0]
        led = cls(clock=lambda: t[0])
        led.book_dispatch(0.01, prefill_positions=0, decode_positions=0,
                          total_positions=0,
                          owners=[("tA", "interactive", 5)],
                          draft_positions=5)
        led.book_dispatch(0.03, prefill_positions=0, decode_positions=5,
                          total_positions=32,
                          owners=[("tA", "interactive", 5)],
                          drafted=4, draft_accepted=3)
        t[0] = 0.1
        snaps.append(led.snapshot())
    jax_s, port_s = snaps
    for k in ("draft_positions", "spec_drafted", "spec_accepted",
              "spec_accept_rate", "useful_positions", "total_positions",
              "token_efficiency"):
        assert port_s[k] == pytest.approx(jax_s[k]), k
    assert port_s["tenants"]["tA"] == pytest.approx(jax_s["tenants"]["tA"])
    assert port_s["phase_seconds"]["draft_compute"] \
        == pytest.approx(0.01, abs=1e-12)


def test_rejections_lower_token_efficiency_as_jax(models, alt):
    prompts = _prompts(5, (6, 6, 6))
    effs = []
    for draft in (models, alt):
        je, te = _pair(models, draft, num_slots=1, economics=True)
        jh = _run(je, prompts, max_new_tokens=12)
        th = _run(te, prompts, max_new_tokens=12)
        assert_spec_equal(je, te, jh, th)
        jl, tl = je.ledger.snapshot(), te.ledger.snapshot()
        for k in ("draft_positions", "spec_drafted", "spec_accepted",
                  "spec_accept_rate", "useful_positions",
                  "total_positions", "token_efficiency", "prefill_tokens",
                  "decode_tokens"):
            assert tl[k] == jl[k], (k, jl[k], tl[k])
        assert sum(v["draft_tokens"] for v in tl["tenants"].values()) \
            == tl["draft_positions"] > 0
        assert sum(v["tokens"] for v in tl["tenants"].values()) \
            == tl["useful_positions"]
        effs.append(tl["token_efficiency"])
    assert effs[1] < effs[0]


# ---- the draft failure protocol ----

def _events(fr):
    keep = ("solo_probe", "draft_quarantine", "draft_failure",
            "draft_disabled", "dispatch_failure", "quarantine")
    return [{k: v for k, v in e.items() if k not in EVENT_DROP}
            for e in fr().snapshot()["events"] if e["kind"] in keep]


@pytest.mark.parametrize("spec,prompts,over,disables", [
    ("poison_request@0:draft", [(1, 6), (11, 16)], {}, False),
    ("poison_request@0:draft;poison_request@1:draft", [(1, 7), (21, 27)],
     {"breaker_threshold": 2}, True),
], ids=["quarantine_one_draft", "unattributable_disables_spec"])
def test_draft_failures_match_jax(models, spec, prompts, over, disables):
    from paddle_tpu.obs.flight_recorder import flight_recorder as jfr
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder as tfr
    ps = [np.arange(a, b, dtype=np.int32) for a, b in prompts]
    ref = _run(_plain(models), ps, max_new_tokens=10)
    je, te = engine_pair(*models, {**CFG, **over}, fault_plan=spec,
                         jax_steps=JAX_STEPS, drafts=models)
    jfr().clear()
    tfr().clear()
    jh = _run(je, ps, max_new_tokens=10)
    th = _run(te, ps, max_new_tokens=10)
    assert_spec_equal(je, te, jh, th)
    assert _streams_equal(th, ref)
    assert te.plan.log == je.plan.log
    assert _events(tfr) == _events(jfr)
    snap = te.metrics.snapshot()
    assert te.supervisor.stats["exempt_failures"] >= 1
    assert te.supervisor.stats["dispatch_failures"] == 0
    assert not te.broken and snap["quarantined"] == 0
    if disables:
        assert te._spec_disabled and snap["spec_windows"] == 0
        assert snap["spec_draft_quarantines"] == 0
    else:
        assert snap["spec_draft_quarantines"] == 1
        assert snap["spec_windows"] > 0
        quar = [e for e in _events(tfr) if e["kind"] == "draft_quarantine"]
        assert [e["submit_idx"] for e in quar] == [0]


# ---- composition with sampling, grammars and adapters ----

def test_sampled_spec_equals_plain_sampled_and_jax(models):
    prompt = np.arange(1, 9, dtype=np.int32)
    knobs = dict(temperature=0.8, top_k=50, top_p=0.95, seed=99)
    ref = _run(_plain(models, n_blocks=8), [prompt], max_new_tokens=16,
               sampling=_sp("port", **knobs))
    je, te = _pair(models, models, n_blocks=8)
    jh = _run(je, [prompt], max_new_tokens=16, logprobs=True,
              sampling=_sp("jax", **knobs))
    th = _run(te, [prompt], max_new_tokens=16, logprobs=True,
              sampling=_sp("port", **knobs))
    assert_spec_equal(je, te, jh, th)
    assert _streams_equal(th, ref)
    snap = te.metrics.snapshot()
    assert snap["spec_accepted"] > 0 and snap["sampled_tokens"] == 16


def test_constrained_requests_never_speculate(models):
    import json
    tokens = {1: "{", 2: "}", 3: '"a"', 4: ":", 5: "1", 6: "23", 7: ",",
              8: '"b"', 9: "true", 10: "false"}
    schema = {"type": "object", "properties": {
        "a": {"type": "integer"}, "b": {"type": "boolean"}},
        "required": ["a", "b"]}
    grammar = {"schema": schema, "tokens": tokens}
    je, te = _pair(models, models, n_blocks=8)
    hs = []
    for pkg, eng in (("jax", je), ("port", te)):
        hs.append([eng.submit(np.arange(1, 9, dtype=np.int32),
                              max_new_tokens=40,
                              sampling=_sp(pkg, temperature=1.0, seed=7,
                                           grammar=grammar)),
                   eng.submit(np.arange(2, 10, dtype=np.int32),
                              max_new_tokens=12)])
        drain(eng)
    assert_spec_equal(je, te, *hs)
    toks = hs[1][0].result(0)
    snap = te.metrics.snapshot()
    assert snap["spec_windows"] > 0
    assert snap["constrained_tokens"] == toks.size
    assert te.draft_pool.stats["allocs"] == 1     # the greedy mate's
    json.loads("".join(tokens[int(t)] for t in toks))


def test_adapter_row_speculates_beside_a_base_row(models):
    """An adapter stream speculates with the base draft; its verify
    carries its adapter. Both streams equal the armed JAX pair's and the
    armed port engine's without a draft."""
    cfg = dict(CFG, n_blocks=8, max_adapters=2, lora_rank=4)
    tree = adapter_tree(models[1], 1)
    je, te = armed_engine_pair(*models, cfg, {"ad1": tree},
                               jax_steps=JAX_STEPS, drafts=models)
    plain = _plain(models, **{k: cfg[k] for k in ("n_blocks",
                                                  "max_adapters",
                                                  "lora_rank")})
    plain.register_adapter("ad1", tree)
    prompt = np.arange(3, 11, dtype=np.int32)
    hs = []
    for eng in (je, te, plain):
        hs.append([eng.submit(prompt, max_new_tokens=10, adapter=a)
                   for a in (None, "ad1")])
        drain(eng)
    assert_spec_equal(je, te, hs[0], hs[1])
    assert _streams_equal(hs[1], hs[2])
    assert not np.array_equal(hs[1][0].result(0), hs[1][1].result(0))
    assert te.spec_windows > 0
    assert te.metrics.adapter_tokens == plain.metrics.adapter_tokens


# ---- the builders ----

def test_make_verify_fn_matches_jax(models):
    from paddle_tpu.models.generation import make_verify_fn as jax_verify
    from paddle_tpu_torch.models.generation import make_verify_fn
    from _torch_port import jax_caches
    jm, tm = models
    ids = np.random.RandomState(3).randint(1, 500, (2, 9)).astype(np.int32)
    jp, jv = jax_verify(jm)
    import jax.numpy as jnp
    jt, _ = jv(jp, jnp.asarray(ids), jax_caches(jm, 2, 16), 0)
    tp, tv = make_verify_fn(tm)
    tt, _ = tv(tp, torch.from_numpy(ids), tm.init_cache(2, 16), 0)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_config_checks_match_jax(models):
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.serving.llm import LLMEngineConfig
    for cls in (JaxConfig, LLMEngineConfig):
        assert cls().spec_k == 4
        with pytest.raises(ValueError, match="spec_k"):
            cls(spec_k=0)
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu_torch.serving.llm import LLMEngine
    for eng, cfg, m in ((JaxEngine, JaxConfig, models[0]),
                        (LLMEngine, LLMEngineConfig, models[1])):
        with pytest.raises(ValueError, match="prefill_chunk"):
            eng(m, cfg(**CFG, spec_k=16, prefill_chunk=16), draft_model=m)


# ---- the draft's in-place writes (the port's own hazards) ----

def _decoding_engine(models, prompt):
    """A self-draft engine whose one request has committed a window, and
    (slot, request, draft row, committed draft length)."""
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(models[1], LLMEngineConfig(**CFG), clock=SimClock(),
                    draft_model=models[1])
    eng.submit(prompt, max_new_tokens=12)
    eng.pump()
    eng.pump()
    assert eng.spec_windows == 1
    slot, req = next(iter(eng._active.items()))
    return eng, slot, req, req.draft_slot, int(eng.draft_pool.lengths[
        req.draft_slot])


def _draft_kv(eng, ds, n):
    return [(k[ds, :, :n].clone(), v[ds, :, :n].clone())
            for k, v in eng.draft_pool.slabs]


def _kv_equal(a, b):
    return all(torch.equal(k, rk) and torch.equal(v, rv)
               for (k, v), (rk, rv) in zip(a, b))


def test_draft_probe_leaves_committed_draft_kv_bit_equal(models):
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder
    from paddle_tpu_torch.serving.supervisor import DispatchFailedError
    eng, slot, req, ds, dlen = _decoding_engine(models,
                                                np.arange(1, 9, dtype=np.int32))
    before = _draft_kv(eng, ds, dlen)
    flight_recorder().clear()
    eng._draft_failure([(slot, req)], DispatchFailedError("injected"),
                       "propose")
    probes = [e for e in flight_recorder().snapshot()["events"]
              if e["kind"] == "solo_probe"]
    assert [(e["stage"], e["outcome"]) for e in probes] == [("draft", "ok")]
    assert _kv_equal(_draft_kv(eng, ds, dlen), before)
    assert int(eng.draft_pool.lengths[ds]) == dlen
    drain(eng)
    assert eng.draft_pool.check_balance()


def test_jax_draft_probe_addressing_would_overwrite_committed_kv(
        models, monkeypatch):
    """The control: the same probe at JAX's position 0 writes its K+1
    stripes over the row's committed draft positions 0..K."""
    from paddle_tpu_torch.serving.llm import llm_engine
    from paddle_tpu_torch.serving.supervisor import DispatchFailedError
    probe = llm_engine.LLMEngine._probe_draft_args
    monkeypatch.setattr(llm_engine.LLMEngine, "_probe_draft_args",
                        lambda self, tok, ds, at: probe(self, tok, ds, 0))
    eng, slot, req, ds, dlen = _decoding_engine(models,
                                                np.arange(1, 9, dtype=np.int32))
    before = _draft_kv(eng, ds, dlen)
    eng._draft_failure([(slot, req)], DispatchFailedError("injected"),
                       "propose")
    after = _draft_kv(eng, ds, dlen)
    K = eng.config.spec_k
    assert not torch.equal(after[0][0][:, :K + 1], before[0][0][:, :K + 1])
    assert torch.equal(after[0][0][:, K + 1:], before[0][0][:, K + 1:])


FENCE = dict(num_slots=1, block_len=8, n_blocks=4, prefill_chunk=8,
             max_new_tokens=20, enable_prefix_cache=False)
WAIT_S = 10.0


def _abandoned_draft_run(models):
    """A threaded self-spec engine (its draft a second twin of the same
    weights) with the watchdog at 0.5 s. A pre-hook on the draft's layer
    1 holds the first draft attempt after 2 committed steps, layer 0
    having written its stripes; the watchdog abandons it and the pump
    runs on (the draft probe passes, the stream continues). A second
    request of other tokens then reuses the draft row. With the engine
    idle, the draft slabs are read and the hook lets the held attempt go
    on. Returns (first stream, held token, draft slabs before and after
    the let-go, engine)."""
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    draft = tiny_models()[1]
    eng = LLMEngine(models[1], LLMEngineConfig(**FENCE,
                                               dispatch_timeout_s=0.5),
                    draft_model=draft)
    gate, held = threading.Event(), threading.Event()
    box = {}

    def hold(module, args):
        if not held.is_set() and eng.steps >= 2:
            box["fence"] = attention._KV_GUARD.guard
            held.set()
            gate.wait(WAIT_S)

    hook = draft.gpt.layers[1].register_forward_pre_hook(hold)
    try:
        eng.start()
        h = eng.submit(np.arange(3, 11, dtype=np.int32))
        assert held.wait(WAIT_S)
        out = h.result(WAIT_S)
        eng.submit(np.arange(300, 308, dtype=np.int32)).result(WAIT_S)
        t0 = time.monotonic()
        while eng.has_work():
            assert time.monotonic() - t0 < WAIT_S
            time.sleep(0.005)
        before = [(k.clone(), v.clone()) for k, v in eng.draft_pool.slabs]
        gate.set()
        for t in threading.enumerate():
            if t.name == "pdtt-llm-dispatch":
                t.join(WAIT_S)
        after = [(k.clone(), v.clone()) for k, v in eng.draft_pool.slabs]
    finally:
        gate.set()
        hook.remove()
        eng.stop(drain=True, timeout=WAIT_S)
    assert eng.draft_pool.check_balance()
    return out, box["fence"], before, after, eng


def test_abandoned_draft_attempt_writes_nothing_after_revocation(models):
    from paddle_tpu_torch.serving.llm.llm_engine import _AttemptRevoked
    ref = _run(_plain(models, **FENCE), [np.arange(3, 11, dtype=np.int32)])
    out, fence, before, after, eng = _abandoned_draft_run(models)
    assert fence in eng.abandoned_attempts and fence.revoked
    assert fence.stopped.is_set()
    assert isinstance(fence.error, _AttemptRevoked)
    assert eng.supervisor.stats["watchdog_fires"] >= 1
    assert eng.supervisor.stats["dispatch_failures"] == 0
    assert not eng.broken and eng._draft_failstreak == 0
    np.testing.assert_array_equal(out, ref[0].result(0))
    assert _kv_equal(after, before)


def test_without_the_fence_the_abandoned_draft_write_lands(models,
                                                           monkeypatch):
    from paddle_tpu_torch.serving.llm import llm_engine
    monkeypatch.setattr(llm_engine._WriteFence, "check", lambda self: None)
    out, fence, before, after, _ = _abandoned_draft_run(models)
    assert fence.error is None
    assert not _kv_equal(after, before)
