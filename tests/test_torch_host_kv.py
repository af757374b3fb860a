"""The port's host KV tier and stream handoff against the JAX package, on
the CPU, after tests/test_tiered.py.

- `serving/llm/host_kv.py`: `HostKVPool`'s byte-budgeted LRU (oldest
  page out first, a get() bumps recency, an oversized page refused),
  tenant keys, owned copies and `clear(only=)`, run beside the JAX pool
  with the same pages: the same snapshots, probes and evictions, and the
  same byte count for a bf16 page (torch bf16 against ml_dtypes');
- the engine with `host_kv_bytes` set, cache on in both packages
  (SimClock, gpt2-tiny): pressure spills the LRU prefix to the host tier
  and a resubmission onboards it, the stream equal to the cold one; the
  host tier is tenant-namespaced. Both engines show equal streams,
  prefill / onboard / import token counts, prefix and host-tier metrics,
  pool and trie stats and evicted pages, and balanced ledgers;
- `export_stream` from one port engine into `submit(prompt + emitted,
  kv_row=, lane=, sample_offset=)` on another, greedy and seeded-sampled:
  a one-token prefill that continues the stream as the uninterrupted JAX
  engine emits it.
"""
import numpy as np
import pytest
import torch

from _torch_port import assert_engines_equal, drain, engine_pair, tiny_models

TIERED = dict(num_slots=2, block_len=8, n_blocks=4, prefill_chunk=16,
              host_kv_bytes=1 << 22)


def _pools(budget, block_len=4):
    from paddle_tpu.serving.llm import HostKVPool as JaxHostKV
    from paddle_tpu_torch.serving.llm import HostKVPool
    return JaxHostKV(budget, block_len), HostKVPool(budget, block_len)


def _page(fill, torch_side, shape=(2, 4, 3)):
    k = np.full(shape, fill, np.float32)
    if torch_side:
        return [(torch.from_numpy(k.copy()), torch.from_numpy(-k))]
    return [(k, -k)]


def test_host_kv_pool_lru_budget_and_tenant_keys():
    page_bytes = 2 * (2 * 4 * 3 * 4)
    paths = [tuple(range(i * 4, i * 4 + 4)) for i in range(4)]

    def scenario(pool, t):
        out = []
        with pytest.raises(ValueError, match="multiple"):
            pool.put("t", [1, 2, 3], _page(0.0, t))
        for i in range(3):
            assert pool.put("t", paths[i], _page(float(i), t))
        assert pool.pages == 3 and pool.bytes_used == 3 * page_bytes
        assert pool.get("t", paths[0]) is not None    # bump the oldest
        assert pool.put("t", paths[3], _page(3.0, t))
        assert pool.get("t", paths[1]) is None        # evicted
        assert pool.get("t", paths[0]) is not None
        out.append(pool.snapshot())
        big = _page(0.0, t, shape=(2, 4, 300))
        assert not pool.put("t", paths[0], big)       # refused outright
        assert pool.get("other", paths[0]) is None
        out += [pool.probe("other", list(paths[0])),
                pool.probe("t", list(paths[0]) + [99]),
                pool.probe("t", list(paths[0]) + list(range(4, 8))),
                pool.snapshot()]
        src = _page(7.5, t)
        pool.put("t2", paths[0], src)
        src[0][0][:] = 0.0                            # mutate the original
        k, v = pool.get("t2", paths[0])[0]
        np.testing.assert_array_equal(np.asarray(k),
                                      np.full((2, 4, 3), 7.5, np.float32))
        np.testing.assert_array_equal(np.asarray(v),
                                      np.full((2, 4, 3), -7.5, np.float32))
        pool.clear(only=lambda ns: ns == "t2")
        out.append(pool.snapshot())
        pool.clear()
        assert pool.pages == 0 and pool.bytes_used == 0
        return out

    jp, tp = _pools(3 * page_bytes)
    assert scenario(tp, True) == scenario(jp, False)


def test_bf16_page_bytes_match_jax():
    """numpy has no bfloat16: the port carries bf16 pages as CPU torch
    tensors, the JAX tier as ml_dtypes arrays; both count 2 bytes an
    element, so one budget evicts alike."""
    import ml_dtypes
    jp, tp = _pools(10_000, block_len=8)
    x = np.random.RandomState(0).standard_normal((4, 8, 16))
    jx = x.astype(ml_dtypes.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for pool, a in ((jp, jx), (tp, tx)):
        for i in range(5):
            pool.put("t", tuple(range(8 * i, 8 * i + 8)), [(a, a)])
    assert tp.snapshot() == jp.snapshot()
    assert tp.bytes_used == 4 * 2 * x.size * 2       # 4 pages kept
    k, _ = tp.get("t", tuple(range(32, 40)))[0]
    assert k.dtype == torch.bfloat16 and torch.equal(k, tx)


def _spill_scenario(eng, prompts, tenants):
    handles = []
    for p, ten in zip(prompts, tenants):
        handles.append(eng.submit(p, max_new_tokens=6, tenant=ten,
                                  logprobs=True))
        drain(eng)
    return handles


def test_pressure_spill_then_host_onboard_bit_identical():
    """Three distinct 17-token prompts (2 full blocks and a 1-token tail)
    through 2 slots: the third admission evicts the first prompt's blocks
    into the host tier; resubmitting it onboards 16 tokens, prefills 1,
    and emits the cold stream."""
    from paddle_tpu_torch.models.generation import generate
    jm, tm = tiny_models()
    rng = np.random.RandomState(11)
    pA, pB, pC = (rng.randint(1, 500, size=(17,)).astype(np.int32)
                  for _ in range(3))
    je, te = engine_pair(jm, tm, TIERED)
    handles = []
    for eng in (je, te):
        hs = _spill_scenario(eng, (pA, pB, pC), ["default"] * 3)
        ten = eng.config.default_tenant
        assert eng.host_kv.pages >= 2
        assert eng.prefix_cache.probe(ten, pA) == 0       # off the device
        assert eng.prefix_probe(pA) == 16                 # host answers
        assert eng.prefix_cache.spilled_pages >= 2
        before = eng.prefill_tokens
        hs += _spill_scenario(eng, (pA,), [ten])
        assert eng.host_onboard_tokens == 16
        assert eng.prefill_tokens - before == 1
        snap = eng.host_kv.snapshot()
        assert snap["onboards"] == 2 and snap["spills"] >= 2
        handles.append(hs)
    jh, th = handles
    np.testing.assert_array_equal(th[3].result(0), th[0].result(0))
    ref = generate(tm, pA[None], max_new_tokens=6).numpy()[0, 17:]
    np.testing.assert_array_equal(th[3].result(0), ref)
    assert te.prefix_cache.spill_seconds == je.prefix_cache.spill_seconds
    assert_engines_equal(je, te, jh, th)
    # the spilled pages hold the same KV, in the slab dtype, on the host
    key = next(iter(te.host_kv._pages))
    for (tk, tv), (jk, jv) in zip(te.host_kv._pages[key],
                                  je.host_kv._pages[key]):
        assert tk.device.type == "cpu" and tk.dtype == torch.float32
        np.testing.assert_allclose(tk.numpy(), jk, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tv.numpy(), jv, atol=1e-4, rtol=0)


def test_host_tier_is_tenant_namespaced():
    jm, tm = tiny_models()
    rng = np.random.RandomState(12)
    prompt, f1, f2 = (rng.randint(1, 500, size=(17,)).astype(np.int32)
                      for _ in range(3))
    je, te = engine_pair(jm, tm, TIERED)
    handles = []
    for eng in (je, te):
        hs = _spill_scenario(eng, (prompt, f1, f2), ["alice"] * 3)
        assert eng.host_kv.pages >= 2
        assert eng.prefix_probe(prompt, tenant="alice") >= 8
        assert eng.prefix_probe(prompt, tenant="bob") == 0
        hs += _spill_scenario(eng, (prompt,), ["bob"])
        assert eng.host_onboard_tokens == 0       # no cross-tenant onboard
        handles.append(hs)
    np.testing.assert_array_equal(handles[1][3].result(0),
                                  handles[1][0].result(0))
    assert_engines_equal(je, te, *handles)


@pytest.mark.parametrize("seed,at", [(None, 1), (77, 3)])
def test_handoff_continues_the_stream(seed, at):
    """A stream exported after `at` tokens and resubmitted with its
    kv_row and lane on a second engine continues as the uninterrupted JAX
    engine emits it (greedy, and seeded top-k / top-p), with a one-token
    prefill that imports len(prompt) + at - 1 tokens."""
    from paddle_tpu.serving.clock import SimClock as JaxSimClock
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu.serving.llm.sampling import SamplingParams as JaxSP
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import (LLMEngine, LLMEngineConfig,
                                              SamplingParams)
    jm, tm = tiny_models()
    cfg = dict(num_slots=4, block_len=8, n_blocks=4)
    knobs = (None if seed is None
             else dict(temperature=0.9, top_k=50, top_p=0.95, seed=seed))
    prompt = np.arange(5, 17, dtype=np.int32)
    NEW = 12
    je = JaxEngine(jm, JaxConfig(**cfg), clock=JaxSimClock())
    ref = je.submit(prompt, max_new_tokens=NEW, logprobs=True,
                    sampling=None if knobs is None else JaxSP(**knobs))
    drain(je)
    sp = None if knobs is None else SamplingParams(**knobs)
    src = LLMEngine(tm, LLMEngineConfig(**cfg), clock=SimClock())
    dst = LLMEngine(tm, LLMEngineConfig(**cfg), clock=SimClock())
    h = src.submit(prompt, max_new_tokens=NEW, logprobs=True, sampling=sp,
                   rid="stream-1")
    while len(h.tokens_so_far()) < at:
        src.pump()
    payload = src.export_stream("stream-1")
    assert not src.has_work() and src.pool.check_balance()
    assert not h.future.done()            # the receiving handle carries on
    emitted = payload["emitted"]
    assert len(emitted) == at and payload["tenant"] == "default"
    kv = payload["kv_row"]
    assert kv["length"] == len(prompt) + at - 1
    assert all(k.device.type == "cpu" and k.shape[1] == kv["length"]
               for k, _ in kv["layers"])
    with pytest.raises(ValueError, match="no active stream"):
        src.export_stream("stream-1")
    h2 = dst.submit(np.concatenate([prompt, emitted]).astype(np.int32),
                    max_new_tokens=NEW - at, logprobs=True, sampling=sp,
                    sample_offset=at, kv_row=kv, lane=payload["lane"])
    drain(dst)
    assert dst.kv_import_tokens == len(prompt) + at - 1
    assert dst.prefill_tokens == 1
    np.testing.assert_array_equal(
        list(emitted) + list(h2.result(0)), ref.result(0))
    np.testing.assert_allclose(payload["logprobs"] + h2.logprobs_so_far(),
                               ref.logprobs_so_far(), atol=1e-4, rtol=0)
    assert dst.pool.check_balance()
    bad = dict(kv, length=len(prompt) + at)
    with pytest.raises(ValueError, match="kv_row length"):
        dst.submit(np.concatenate([prompt, emitted]).astype(np.int32),
                   kv_row=bad)
    with pytest.raises(ValueError, match="block_len"):
        dst.submit(np.concatenate([prompt, emitted]).astype(np.int32),
                   kv_row=dict(kv, block_len=16))


def test_export_stream_refuses_mid_prefill():
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    _, tm = tiny_models()
    eng = LLMEngine(tm, LLMEngineConfig(num_slots=2, block_len=8,
                                        n_blocks=8, prefill_chunk=8),
                    clock=SimClock())
    h = eng.submit(np.arange(1, 30, dtype=np.int32), max_new_tokens=2)
    eng.pump()                             # one chunk of four
    with pytest.raises(ValueError, match="not completed prefill"):
        eng.export_stream(h.rid)
    drain(eng)
    assert len(h.result(0)) == 2
