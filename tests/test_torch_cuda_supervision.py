"""Serving supervision on the card (`cuda` marker; skipped without a GPU):
the KV write fence of `LLMEngine` with really abandoned attempts.

gpt3-1.3b's widths cut to 2 layers, bf16, one slot: a forward pre-hook on
layer 1 holds the first attempt of a decode step after layer 0 has
enqueued its KV write; the 0.5 s watchdog abandons it, the retry's
kernels are enqueued and committed, the engine runs 3 more steps, and
only then does the hook let the held attempt go on: it must stop at its
next KV write (the fence), and the slabs at every committed position must
equal a fault-free run's bit for bit, as must the stream. A second test
checks that an attempt run on a deadline thread launches on the CUDA
stream that was current on the engine thread. No JAX here: on the card's
machine run it with `python -m pytest --noconftest`.
"""
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import require_cuda

CFG = dict(num_slots=1, block_len=8, n_blocks=8, prefill_chunk=8,
           max_new_tokens=24, enable_prefix_cache=False)
PROMPT = np.arange(5, 21, dtype=np.int32)
HOLD_STEP = 4
WAIT_S = 60.0


def _model():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return GPTForCausalLM.from_preset("gpt3-1.3b", dtype="bfloat16",
                                      generator=gen, num_hidden_layers=2)


def _committed(eng, n):
    return [(k[0, :, :n].clone(), v[0, :, :n].clone())
            for k, v in eng.pool.slabs]


@pytest.mark.cuda
def test_cuda_fence_stops_abandoned_attempt():
    require_cuda()
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.serving.llm.llm_engine import _AttemptRevoked
    model = _model()
    ref_eng = LLMEngine(model, LLMEngineConfig(**CFG), clock=SimClock())
    h = ref_eng.submit(PROMPT)
    while ref_eng.has_work():
        ref_eng.pump()
    ref = h.result(0)

    eng = LLMEngine(model, LLMEngineConfig(**CFG, dispatch_timeout_s=0.5))
    gate, held = threading.Event(), threading.Event()
    box = {}

    def hold(module, args):
        if not held.is_set() and eng.steps >= HOLD_STEP:
            box["fence"] = attention._KV_GUARD.guard
            box["step"] = eng.steps
            held.set()
            gate.wait(WAIT_S)

    hook = model.gpt.layers[1].register_forward_pre_hook(hold)
    try:
        eng.start()
        h = eng.submit(PROMPT)
        assert held.wait(WAIT_S)
        t0 = time.monotonic()
        while eng.steps < box["step"] + 4:      # the retry and 3 more
            assert time.monotonic() - t0 < WAIT_S
            time.sleep(0.002)
        torch.cuda.synchronize()
        gate.set()
        fence = box["fence"]
        assert fence.stopped.wait(WAIT_S)
        out = h.result(WAIT_S)
    finally:
        gate.set()
        hook.remove()
        eng.stop(drain=True, timeout=WAIT_S)
    assert isinstance(fence.error, _AttemptRevoked)
    assert fence in eng.abandoned_attempts
    assert eng.supervisor.snapshot()["watchdog_fires"] >= 1
    np.testing.assert_array_equal(out, ref)
    torch.cuda.synchronize()
    n = len(PROMPT) + len(out) - 1
    for (k, v), (rk, rv) in zip(_committed(eng, n), _committed(ref_eng, n)):
        assert torch.equal(k, rk) and torch.equal(v, rv)


@pytest.mark.cuda
def test_cuda_attempt_runs_on_the_engine_threads_stream():
    require_cuda()
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    model = _model()
    seen = []

    def record(module, args):
        seen.append((threading.get_ident(), torch.cuda.current_stream()))

    hook = model.gpt.layers[0].register_forward_pre_hook(record)
    side = torch.cuda.Stream()
    try:
        eng = LLMEngine(model, LLMEngineConfig(**CFG, dispatch_timeout_s=5.0),
                        clock=SimClock())
        h = eng.submit(PROMPT, max_new_tokens=3)
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            while eng.has_work():
                eng.pump()
        h.result(0)
    finally:
        hook.remove()
    assert len(seen) == eng.steps == 4
    assert all(t != threading.get_ident() for t, _ in seen)
    assert all(s == side for _, s in seen)
