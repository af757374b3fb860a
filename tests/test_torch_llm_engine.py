"""The PyTorch port's continuous-batching LLMEngine against the JAX one.

Both engines run on a SimClock with the same gpt2-tiny weights (bridged
into the port; the streams also with llama2-tiny's, with and without
grouped-query attention) and the same mixed-length prompts, some longer than
`prefill_chunk`; both engines have their prefix cache off (its parity is
tests/test_torch_prefix_cache.py's). Token streams must be identical,
logprobs within 1e-4, and the port's streams equal to the port's own
`generate()`. Also
covered: the pool ledger, slot reuse, queue-full rejects and shedding,
deadline drops and evictions, drain and shutdown, and the threaded
scheduler on a MonotonicClock.
"""
import numpy as np
import pytest

from _torch_port import tiny_models

CFG = dict(num_slots=3, block_len=8, n_blocks=8, prefill_chunk=16,
           max_new_tokens=7, enable_prefix_cache=False)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lens]


def _port_engine(tm, **over):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    return LLMEngine(tm, LLMEngineConfig(**{**CFG, **over}),
                     clock=SimClock())


def _drain(engine):
    while engine.has_work():
        engine.pump()


def _streams_match_jax_engine_and_generate(jm, tm):
    from paddle_tpu.serving.clock import SimClock as JaxSimClock
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    from paddle_tpu_torch.models.generation import generate
    prompts = _prompts(1, (5, 21, 9, 40, 3, 17, 33))
    je = JaxEngine(jm, JaxConfig(**CFG),
                   clock=JaxSimClock())
    te = _port_engine(tm)
    jh = [je.submit(p, logprobs=True) for p in prompts]
    th = [te.submit(p, logprobs=True) for p in prompts]
    _drain(je)
    _drain(te)
    for p, a, b in zip(prompts, jh, th):
        np.testing.assert_array_equal(b.result(0), a.result(0))
        np.testing.assert_allclose(b.logprobs_so_far(),
                                   a.logprobs_so_far(), atol=1e-4, rtol=0)
        ref = generate(tm, p[None], max_new_tokens=7).numpy()[0, len(p):]
        np.testing.assert_array_equal(b.result(0), ref)
        assert b.ttft_ms is not None
    assert te.decode_iterations == je.decode_iterations
    assert te.prefill_dispatches == je.prefill_dispatches
    assert te.prefill_tokens == je.prefill_tokens == sum(map(len, prompts))
    assert te.pool.check_balance()
    snap = te.metrics.snapshot()
    assert snap["completed"] == len(prompts) and snap["tokens_out"] > 0


def test_streams_match_jax_engine_and_generate(models):
    _streams_match_jax_engine_and_generate(*models)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_llama_streams_match_jax_engine_and_generate(kv_heads):
    """llama2-tiny behind both engines, as given (4 kv heads) and with
    grouped-query attention (2 kv heads a 4 query heads): its pool holds
    kv_heads-head slabs."""
    jm, tm = tiny_models("llama2-tiny", num_key_value_heads=kv_heads)
    _streams_match_jax_engine_and_generate(jm, tm)


def test_eos_streams_match_jax_engine(models):
    from paddle_tpu.serving.clock import SimClock as JaxSimClock
    from paddle_tpu.serving.llm import LLMEngine as JaxEngine
    from paddle_tpu.serving.llm import LLMEngineConfig as JaxConfig
    jm, tm = models
    prompts = _prompts(2, (6, 19, 12))
    te = _port_engine(tm)
    free = [te.submit(p) for p in prompts]
    _drain(te)
    eos = int(free[1].result(0)[2])      # stream 1 ends at its 3rd token
    je = JaxEngine(jm, JaxConfig(**CFG),
                   clock=JaxSimClock())
    jh = [je.submit(p, eos_token_id=eos) for p in prompts]
    th = [te.submit(p, eos_token_id=eos) for p in prompts]
    _drain(je)
    _drain(te)
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.result(0), a.result(0))
    assert len(th[1].result(0)) == 3 and th[1].result(0)[-1] == eos
    assert te.pool.check_balance()


def test_pool_ledger_and_slot_reuse(models):
    _, tm = models
    te = _port_engine(tm, num_slots=2)
    hs = [te.submit(p, max_new_tokens=3) for p in _prompts(3, (4, 9, 6, 2))]
    _drain(te)
    for h in hs:
        assert len(h.result(0)) == 3
    st = te.pool.stats
    assert st["allocs"] == 4 and st["frees"] == 4 and st["reuses"] == 2
    assert st["peak_active"] == 2
    assert te.pool.check_balance()
    assert te.pool.active_slots() == 0 and te.pool.used_blocks() == 0


def test_pool_units():
    import torch
    from paddle_tpu_torch.serving.llm import (SlotPagedKVPool,
                                              SlotsExhaustedError)

    def init_cache(b, max_len, **kw):
        z = torch.zeros((b, 2, max_len, 3))
        return [(z, z.clone())]

    p = SlotPagedKVPool(init_cache, 2, 4, 3, pad_tokens=2)
    assert p.capacity == 12 and p.slab_len == 14
    s = p.allocate(10)
    p.set_length(s, 5)
    assert p.block_table[s] == [0, 1]
    np.testing.assert_array_equal(p.device_block_table().numpy(),
                                  [[0, 1, 2], [3, 4, 5]])
    np.testing.assert_array_equal(p.device_seq_lens().numpy(), [5, 0])
    with pytest.raises(ValueError, match="capacity"):
        p.allocate(13)
    p.allocate(1)
    with pytest.raises(SlotsExhaustedError):
        p.allocate(1)
    p.free(s)
    with pytest.raises(ValueError):
        p.free(s)
    assert p.check_balance()
    p.stats["blocks_allocated"] += 1          # a leaked page is caught
    with pytest.raises(AssertionError, match="block ledger"):
        p.check_balance()


def test_queue_full_reject_and_shed(models):
    from paddle_tpu_torch.serving.engine import RejectedError
    _, tm = models
    te = _port_engine(tm, max_queue_depth=2)
    p = _prompts(4, (5,))[0]
    low = te.submit(p, slo="best_effort")
    te.submit(p, slo="batch")
    with pytest.raises(RejectedError) as ei:
        te.submit(p, slo="best_effort")
    assert ei.value.reason == "queue_full"
    hi = te.submit(p, slo="interactive")      # sheds the best_effort one
    with pytest.raises(RejectedError) as ei:
        low.result(0)
    assert ei.value.reason == "shed"
    with pytest.raises(RejectedError) as ei:
        te.submit(np.zeros(100, np.int32))
    assert ei.value.reason == "prompt_too_long"
    _drain(te)
    assert len(hi.result(0)) == 7
    assert te.metrics.snapshot()["reject_reasons"] == {
        "queue_full": 1, "shed": 1, "prompt_too_long": 1}


def test_deadline_drop_and_eviction(models):
    from paddle_tpu_torch.serving.engine import DeadlineExceededError
    _, tm = models
    te = _port_engine(tm, num_slots=1)
    a, b = _prompts(5, (40, 6))
    active = te.submit(a, deadline_ms=50)      # admitted, mid-prefill
    queued = te.submit(b, deadline_ms=50)      # waits for the one slot
    te.pump()
    assert te.pool.active_slots() == 1
    te.clock.advance(0.1)
    te.pump()
    with pytest.raises(DeadlineExceededError, match="mid-prefill"):
        active.result(0)
    with pytest.raises(DeadlineExceededError, match="in queue"):
        queued.result(0)
    assert te.pool.active_slots() == 0 and te.pool.check_balance()
    assert te.metrics.snapshot()["expired"] == 2


def test_stop_drains_then_rejects(models):
    from paddle_tpu_torch.serving.engine import RejectedError
    _, tm = models
    te = _port_engine(tm)
    hs = [te.submit(p) for p in _prompts(6, (4, 30, 8, 2))]
    te.stop(drain=True)
    assert all(len(h.result(0)) == 7 for h in hs)
    with pytest.raises(RejectedError) as ei:
        te.submit(np.array([1, 2], np.int32))
    assert ei.value.reason == "draining"
    with pytest.raises(RuntimeError, match="SimClock"):
        _port_engine(tm).start()
    te2 = _port_engine(tm)
    h = te2.submit(np.array([1, 2, 3], np.int32))
    te2.stop(drain=False)
    with pytest.raises(RejectedError) as ei:
        h.result(0)
    assert ei.value.reason == "shutdown"


def test_threaded_scheduler_on_monotonic_clock(models):
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    _, tm = models
    te = LLMEngine(tm, LLMEngineConfig(**CFG)).start()
    try:
        prompts = _prompts(7, (3, 25, 11))
        hs = [te.submit(p, max_new_tokens=4) for p in prompts]
        outs = [h.result(timeout=120) for h in hs]
    finally:
        te.stop(drain=True, timeout=60)
    assert te._thread is not None and not te._thread.is_alive()
    for p, o in zip(prompts, outs):
        ref = generate(tm, p[None], max_new_tokens=4).numpy()[0, len(p):]
        np.testing.assert_array_equal(o, ref)
