"""Multi-LoRA serving in the port's `LLMEngine` against the JAX engine
(tests/test_lora.py's contracts, the single-engine ones), on gpt2-tiny
twins with bridged weights, both engines armed with an adapter bank of
the same rank and the same synthetic adapters (`adapter_tree`, sigma
0.3: large enough to move greedy tokens at this width), on SimClocks.

- Base rows (bank row 0) on an armed engine: streams and logprobs
  bit-equal to the unarmed port engine's; every stream equal to the armed
  JAX engine's (`assert_engines_equal`: tokens exactly, logprobs within
  1e-4, prefix and pool state).
- A mixed step (base, two adapters, one prompt): each adapter stream
  equals its solo decode on a fresh port engine bit for bit and the JAX
  engine's, and differs from base.
- Typed rejects equal JAX's: adapter_unavailable, unknown_adapter (at
  submit, and at admission after a rollback unloaded the adapter),
  bank_full, a rank mismatch, adapter_in_use; the reject counters equal.
- Prefix KV namespaced by (tenant, adapter): probes equal JAX's, and a
  hot swap flushes exactly the swapped adapter's namespace.
- `poison_request@1:adapter` quarantines the one adapter stream; the
  other streams finish as the JAX engine's, outcomes equal.
- The ledger: the adapter re-bucketing equals JAX's, and an armed
  engine's per-adapter device seconds sum to its tenants'.
- The adapter metric families equal JAX's; `canary_probe(adapter=)` on
  the contiguous cache decodes the JAX engine's adapter stream.
- Churn (load, hot swap, unload) never changes a step's ATen ops: the
  port's counterpart of JAX's zero recompiles.
- A hot swap from another thread between two layers of a step leaves
  that step reading the old bank in every layer (every row equal to the
  all-old run), and the next step reads the new one.
"""
import threading

import numpy as np
import pytest
import torch

from _torch_port import (adapter_tree, armed_engine_pair,  # noqa: F401
                         assert_engines_equal, drain, one_torch_thread,
                         tiny_models)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_slots=4, block_len=8, n_blocks=8, max_queue_depth=64,
           max_adapters=3, lora_rank=4)
JAX_STEPS = {}      # the JAX engines' unified step, compiled once a shape


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def trees(models):
    return {f"ad{s}": adapter_tree(models[1], s) for s in (1, 2, 9)}


def _pair(models, trees, ids=("ad1",), **over):
    jm, tm = models
    return armed_engine_pair(jm, tm, CFG, {a: trees[a] for a in ids},
                             jax_steps=JAX_STEPS, **over)


def _port(models, trees, ids=(), **over):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(models[1], LLMEngineConfig(**{**CFG, **over}),
                    clock=SimClock())
    for a in ids:
        eng.register_adapter(a, trees[a])
    return eng


def _prompts(seed, n, length=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, size=(length,)).astype(np.int32)
            for _ in range(n)]


def _both(je, te, prompt, **kw):
    return je.submit(prompt, **kw), te.submit(prompt, **kw)


def test_base_rows_bit_equal_to_unarmed_engine(models, trees):
    je, te = _pair(models, trees)
    plain = _port(models, trees, max_adapters=0)
    assert plain.adapter_bank is None
    hs = [(_both(je, te, p, max_new_tokens=8, logprobs=True),
           plain.submit(p, max_new_tokens=8, logprobs=True))
          for p in _prompts(0, 3)]
    for e in (je, te, plain):
        drain(e)
    assert_engines_equal(je, te, [h[0][0] for h in hs], [h[0][1] for h in hs])
    for (_, th), ph in hs:
        np.testing.assert_array_equal(th.result(0), ph.result(0))
        assert th.logprobs_so_far() == ph.logprobs_so_far()


def test_mixed_adapter_step_matches_solo_and_jax(models, trees):
    prompt = _prompts(4, 1)[0]
    je, te = _pair(models, trees, ids=("ad1", "ad2"))
    hs = [_both(je, te, prompt, max_new_tokens=8, adapter=a)
          for a in (None, "ad1", "ad2")]
    drain(je)
    drain(te)
    assert_engines_equal(je, te, [h[0] for h in hs], [h[1] for h in hs])
    base = hs[0][1].result(0)
    for (_, th), aid in zip(hs[1:], ("ad1", "ad2")):
        solo = _port(models, trees, ids=(aid,))
        h = solo.submit(prompt, max_new_tokens=8, adapter=aid)
        drain(solo)
        np.testing.assert_array_equal(th.result(0), h.result(0))
        assert not np.array_equal(th.result(0), base), aid


def test_typed_adapter_rejects_match_jax(models, trees):
    from paddle_tpu.serving.engine import RejectedError as JaxRejected
    from paddle_tpu.serving.llm.lora import AdapterError as JaxAdapterError
    from paddle_tpu_torch.serving import RejectedError
    from paddle_tpu_torch.serving.llm import AdapterError
    prompt = np.arange(1, 5, dtype=np.int32)
    plain = _port(models, trees, max_adapters=0)
    with pytest.raises(RejectedError) as e:
        plain.submit(prompt, max_new_tokens=2, adapter="ad1")
    assert e.value.reason == "adapter_unavailable"
    with pytest.raises(AdapterError) as e:
        plain.register_adapter("ad1", trees["ad1"])
    assert e.value.reason == "adapter_unavailable"
    assert plain.metrics.reject_reasons == {"adapter_unavailable": 1}

    je, te = _pair(models, trees, max_adapters=1)
    reasons = []
    for eng, rej, aerr in ((je, JaxRejected, JaxAdapterError),
                           (te, RejectedError, AdapterError)):
        got = []
        with pytest.raises(rej) as e:
            eng.submit(prompt, max_new_tokens=2, adapter="nope")
        got.append(e.value.reason)
        with pytest.raises(aerr) as e:
            eng.register_adapter("ad2", trees["ad2"])
        got.append(e.value.reason)
        with pytest.raises(aerr) as e:
            eng.register_adapter("ad1", adapter_tree(models[1], 1, rank=8))
        got.append(e.value.reason)
        h = eng.submit(prompt, max_new_tokens=16, adapter="ad1")
        eng.pump()                          # the stream is live on its row
        with pytest.raises(aerr) as e:
            eng.unregister_adapter("ad1")
        got.append(e.value.reason)
        drain(eng)
        got.append(len(h.result(0)))
        eng.unregister_adapter("ad1")       # idle now: the unload succeeds
        got.append(eng.adapter_bank.row_of("ad1"))
        # queued, then its adapter unloaded by a rollback: rejected at
        # admission, typed
        snap = eng.register_adapter("ad2", trees["ad2"])
        h = eng.submit(prompt, max_new_tokens=2, adapter="ad2")
        eng.rollback_adapter("ad2", snap)
        drain(eng)
        got.append(h.future.exception(0).reason)
        got.append(dict(eng.metrics.reject_reasons))
        reasons.append(got)
    assert reasons[1] == reasons[0]
    assert reasons[1][:4] == ["unknown_adapter", "bank_full",
                              "adapter_mismatch", "adapter_in_use"]
    assert reasons[1][6] == "unknown_adapter"


def test_adapter_kv_namespaces_and_scoped_flush_match_jax(models, trees):
    je, te = _pair(models, trees, ids=("ad1", "ad2"))
    prompt = np.arange(1, 22, dtype=np.int32)      # 2 full blocks + tail

    def probes():
        return [[e.prefix_probe(prompt, tenant="acme", adapter=a)
                 for a in (None, "ad1", "ad2", "other")] for e in (je, te)]

    for ad in (None, "ad1", "ad2"):
        hs = _both(je, te, prompt, max_new_tokens=2, adapter=ad,
                   tenant="acme")
        drain(je)
        drain(te)
        assert_engines_equal(je, te, [hs[0]], [hs[1]])
    before = probes()
    assert before[1] == before[0] and before[1] == [16, 16, 16, 0]
    for e in (je, te):
        e.register_adapter("ad1", trees["ad9"])       # hot swap
    after = probes()
    assert after[1] == after[0] and after[1] == [16, 0, 16, 0]
    assert te.pool.check_balance()


def test_poisoned_adapter_stream_quarantined_like_jax(models, trees):
    prompt = _prompts(6, 1)[0]
    je, te = _pair(models, trees, ids=("ad1", "ad2"),
                   fault_plan="poison_request@1:adapter")
    hs = [_both(je, te, prompt, max_new_tokens=6, adapter=a)
          for a in (None, "ad1", "ad2")]
    drain(je)
    drain(te)
    for j, t in hs:
        assert (t.future.exception(0) is None) == \
            (j.future.exception(0) is None)
        np.testing.assert_array_equal(t.tokens_so_far(), j.tokens_so_far())
    assert hs[1][1].future.exception(0).reason == "poisoned"
    solo = _port(models, trees, ids=("ad2",))
    h = solo.submit(prompt, max_new_tokens=6, adapter="ad2")
    drain(solo)
    np.testing.assert_array_equal(hs[2][1].result(0), h.result(0))
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for k in ("quarantined", "completed", "failed", "adapter_tokens"):
        assert ts[k] == js[k], k
    assert ts["quarantined"] == 1 and not te.broken
    assert te.plan.log == je.plan.log
    assert te.pool.check_balance()


def test_ledger_adapter_rebucketing_matches_jax(models, trees):
    from paddle_tpu.obs.serving_ledger import ServingLedger as JaxLedger
    from paddle_tpu_torch.obs.serving_ledger import ServingLedger
    snaps = []
    for cls in (JaxLedger, ServingLedger):
        led = cls(clock=lambda: 0.0)
        with led.measure("host"):
            led.book_dispatch(
                0.10, 4, 6, 16,
                owners=[("acme", "interactive", 6), ("beta", "batch", 4)],
                adapter_owners=[("ad1", 6), ("base", 4)])
            led.book_dispatch(
                0.05, 0, 10, 16, owners=[("acme", "interactive", 10)],
                adapter_owners=[("ad1", 4), ("ad2", 6)])
        snaps.append(led.snapshot())
    assert snaps[1]["adapters"] == snaps[0]["adapters"]
    # an armed engine books every row's share by adapter too
    eng = _port(models, trees, ids=("ad1",), economics=True)
    for i, p in enumerate(_prompts(2, 4)):
        eng.submit(p, max_new_tokens=4, adapter=(None, "ad1")[i % 2],
                   tenant=f"t{i % 3}")
    while eng.has_work():
        eng.clock.advance(0.01)
        eng.pump()
    snap = eng.ledger.snapshot()
    ad, ten = snap["adapters"], snap["tenants"]
    assert set(ad) == {"base", "ad1"}
    assert sum(v["tokens"] for v in ad.values()) == \
        sum(v["tokens"] for v in ten.values())
    assert abs(sum(v["device_seconds"] for v in ad.values())
               - sum(v["device_seconds"] for v in ten.values())) < 1e-12


def test_metrics_families_and_canary_match_jax(models, trees):
    from paddle_tpu.serving.metrics import parse_exposition as jparse
    from paddle_tpu_torch.serving.llm import AdapterError
    je, te = _pair(models, trees, ids=())
    prompt = np.arange(1, 6, dtype=np.int32)
    snaps = [e.register_adapter("ad1", trees["ad1"]) for e in (je, te)]
    assert snaps == [None, None]
    # the canary decodes on the contiguous cache what the engine streams
    # (the JAX engine's streams: its eager canary would compile op by op)
    canary = te.canary_probe(prompt, 3, adapter="ad1")
    base_canary = te.canary_probe(prompt, 3)
    with pytest.raises(AdapterError) as e:
        te.canary_probe(prompt, 4, adapter="nope")
    assert e.value.reason == "unknown_adapter"
    hs = [_both(je, te, prompt, max_new_tokens=3, adapter=a)
          for a in ("ad1", None)]
    drain(je)
    drain(te)
    assert canary[1] and base_canary[1]
    np.testing.assert_array_equal(canary[0], hs[0][0].result(0))
    np.testing.assert_array_equal(base_canary[0], hs[1][0].result(0))
    assert not np.array_equal(canary[0], base_canary[0])
    for e in (je, te):
        e.rollback_adapter("ad1", None)          # a fresh load: unload
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    assert ts["adapter_tokens"] == js["adapter_tokens"] == \
        {"ad1": 3, "base": 3}
    # every emitted token: tokens_out counts the decode steps' tokens,
    # each finished prefill emits one more
    assert sum(ts["adapter_tokens"].values()) == \
        ts["tokens_out"] + ts["prefills"]
    fams = [{k: v for k, v in jparse(e.metrics.render()).items()
             if "adapter" in k} for e in (je, te)]
    assert fams[1] == fams[0]
    text = te.metrics.render()
    assert 'pdtpu_llm_adapter_tokens_total{adapter="ad1"} 3' in text
    assert 'pdtpu_llm_adapter_swaps_total 1' in text
    assert 'pdtpu_llm_adapter_rollbacks_total 1' in text


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_adapter_churn_keeps_each_step_ops(models, trees):
    """Every greedy step of an armed engine runs the same ATen ops,
    whatever the bank holds and whichever rows are bound: load, hot swap
    and unload change values, never the step."""
    eng = _port(models, trees, ids=("ad1",))
    counts = []
    inner = eng._step_logits

    def counted(a):
        with _OpCounter() as c:
            out = inner(a)
        counts.append(c.n)
        return out

    eng._step_logits = counted
    prompt = np.arange(1, 7, dtype=np.int32)
    eng.submit(prompt, max_new_tokens=4, adapter="ad1")
    drain(eng)
    eng.register_adapter("ad2", trees["ad2"])        # fresh load
    eng.register_adapter("ad1", trees["ad9"])        # hot swap
    for a in ("ad1", "ad2", None):
        eng.submit(prompt, max_new_tokens=4, adapter=a)
    drain(eng)
    eng.unregister_adapter("ad2")
    eng.submit(prompt, max_new_tokens=4, adapter="ad1")
    drain(eng)
    assert len(counts) == 12 and len(set(counts)) == 1, counts
    plain = _port(models, trees, max_adapters=0)
    plain._step_logits = counted
    plain.submit(prompt, max_new_tokens=1)
    drain(plain)
    assert counts[-1] < counts[0]        # the delta's ops, gone unarmed


def test_hot_swap_between_layers_does_not_tear_a_step(models, trees):
    """A swap from another thread, made and finished while the engine's
    step is between layer 0 and layer 1: every row of that step equals the
    all-old run's (base row and adapter row alike), not the new one's;
    the next step reads the new adapter."""
    tm = models[1]
    prompt = np.arange(3, 12, dtype=np.int32)

    def run(tree, swap=None):
        eng = _port(models, {"ad1": tree}, ids=("ad1",))
        logits = []
        inner = eng._step_logits
        eng._step_logits = lambda a: logits.append(inner(a)) or logits[-1]
        handle = None
        if swap is not None:
            def hook(mod, args, out):
                handle.remove()
                t = threading.Thread(target=eng.register_adapter,
                                     args=("ad1", swap))
                t.start()
                t.join()
            handle = tm.gpt.layers[0].register_forward_hook(hook)
        hs = [eng.submit(prompt, max_new_tokens=2, adapter=a)
              for a in (None, "ad1")]
        drain(eng)
        if handle is not None:
            handle.remove()
        return logits, [h.result(0) for h in hs], eng

    old, _, _ = run(trees["ad1"])
    new, _, _ = run(trees["ad9"])
    torn, _, eng = run(trees["ad1"], swap=trees["ad9"])
    assert eng.adapter_bank.version == 2           # the swap landed
    adv = len(prompt)
    for r in (0, 1):
        assert torch.equal(torn[0][r, :adv], old[0][r, :adv]), r
    assert not torch.equal(torn[0][1, :adv], new[0][1, :adv])
    # the next step has the all-old run's inputs (its first tokens and
    # KV) but reads the new rows: the base row as before, the adapter row
    # moved
    assert torch.equal(torn[1][0, :1], old[1][0, :1])
    assert not torch.equal(torn[1][1, :1], old[1][1, :1])
