"""Speculative decoding on the card (`cuda` marker; skipped without a
GPU). No JAX here: on the card's machine run it with `python -m pytest
--noconftest`.

gpt3-1.3b's widths cut to 2 layers, bf16, as the target; a draft of
gpt3-125m's widths (12 heads of 64) cut to 2 layers from another seed.
- Spec-armed engines (self draft, mismatched draft) give every stream of
  the unarmed engine bit for bit: the engines run the same [N, C] step.
- The draft blame probe leaves the row's committed draft KV bit-equal;
  JAX's position-0 addressing overwrites it.
- A draft attempt abandoned by the 0.5 s watchdog writes nothing into the
  draft slabs once revoked.
- The paged kernel at the propose's shape (Tq = 1, D = 64, block_len 8,
  12 heads) against its plain version under the BF16_PA_* rule, on the
  tensor cores.
"""
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import (assert_bf16_attention_close, paged_inputs,
                         require_cuda)

CFG = dict(num_slots=4, block_len=8, n_blocks=16, prefill_chunk=16,
           max_new_tokens=16, enable_prefix_cache=False)
WAIT_S = 60.0


def _models():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    out = []
    for preset, seed in (("gpt3-1.3b", 0), ("gpt3-125m", 20)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        out.append(GPTForCausalLM.from_preset(
            preset, dtype="bfloat16", generator=gen, num_hidden_layers=2))
    return out


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 50304, (n,)).astype(np.int32)
            for n in (5, 30, 17, 64, 9, 41)]


def _drain(eng, prompts):
    hs = [eng.submit(p) for p in prompts]
    while eng.has_work():
        eng.pump()
    return [h.result(0) for h in hs]


def _engine(model, draft=None, **over):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    return LLMEngine(model, LLMEngineConfig(**{**CFG, **over}),
                     clock=SimClock(), draft_model=draft)


@pytest.mark.cuda
def test_cuda_spec_streams_equal_the_unarmed_engine():
    require_cuda()
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops.paged_attention import TENSOR_CORES
    model, draft = _models()
    prompts = _prompts()
    ref = _drain(_engine(model), prompts)
    for d in (model, draft):
        eng = _engine(model, d)
        _kernels.reset_launch_counts()
        out = _drain(eng, prompts)
        routes = _kernels.route_counts()
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert eng.spec_windows > 0
        assert eng.pool.check_balance() and eng.draft_pool.check_balance()
        assert eng.draft_pool.active_slots() == 0
        assert routes[f"paged_attention:{TENSOR_CORES}"] \
            == _kernels.launch_counts()["paged_attention"] > 0
    assert eng.spec_accepted < eng.spec_drafted      # the mismatched draft


def _committed_draft(eng, ds, n):
    return [(k[ds, :, :n].clone(), v[ds, :, :n].clone())
            for k, v in eng.draft_pool.slabs]


@pytest.mark.cuda
@pytest.mark.parametrize("jax_addressing", [False, True])
def test_cuda_draft_probe_keeps_committed_draft_kv(jax_addressing):
    require_cuda()
    from paddle_tpu_torch.serving.supervisor import DispatchFailedError
    model, draft = _models()
    eng = _engine(model, draft, num_slots=2)
    eng.submit(_prompts()[1])
    while eng.spec_windows == 0:
        eng.pump()
    slot, req = next(iter(eng._active.items()))
    ds = req.draft_slot
    dlen = int(eng.draft_pool.lengths[ds])
    if jax_addressing:
        probe = eng._probe_draft_args
        eng._probe_draft_args = lambda tok, d, at: probe(tok, d, 0)
    before = _committed_draft(eng, ds, dlen)
    eng._draft_failure([(slot, req)], DispatchFailedError("injected"),
                       "propose")
    torch.cuda.synchronize()
    after = _committed_draft(eng, ds, dlen)
    same = all(torch.equal(a, b) for pa, pb in zip(after, before)
               for a, b in zip(pa, pb))
    assert same != jax_addressing


@pytest.mark.cuda
def test_cuda_abandoned_draft_attempt_writes_nothing_after_revocation():
    require_cuda()
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.serving.llm.llm_engine import _AttemptRevoked
    model, draft = _models()
    cfg = dict(CFG, num_slots=1, max_new_tokens=24)
    eng = LLMEngine(model, LLMEngineConfig(**cfg, dispatch_timeout_s=0.5),
                    draft_model=draft)
    gate, held = threading.Event(), threading.Event()
    box = {}

    def hold(module, args):
        if not held.is_set() and eng.steps >= 3:
            box["fence"] = attention._KV_GUARD.guard
            held.set()
            gate.wait(WAIT_S)

    hook = draft.gpt.layers[1].register_forward_pre_hook(hold)
    try:
        eng.start()
        h = eng.submit(_prompts()[2])
        assert held.wait(WAIT_S)
        h.result(WAIT_S)
        # another request's tokens in the same draft row
        eng.submit(_prompts()[0]).result(WAIT_S)
        t0 = time.monotonic()
        while eng.has_work():
            assert time.monotonic() - t0 < WAIT_S
            time.sleep(0.005)
        torch.cuda.synchronize()
        before = [(k.clone(), v.clone()) for k, v in eng.draft_pool.slabs]
        gate.set()
        for t in threading.enumerate():
            if t.name == "pdtt-llm-dispatch":
                t.join(WAIT_S)
        torch.cuda.synchronize()
        after = [(k.clone(), v.clone()) for k, v in eng.draft_pool.slabs]
    finally:
        gate.set()
        hook.remove()
        eng.stop(drain=True, timeout=WAIT_S)
    fence = box["fence"]
    assert fence in eng.abandoned_attempts and fence.stopped.is_set()
    assert isinstance(fence.error, _AttemptRevoked)
    assert eng.supervisor.stats["dispatch_failures"] == 0
    assert all(torch.equal(a, b) for pa, pb in zip(after, before)
               for a, b in zip(pa, pb))


# gpt3-125m's heads behind the serve engine: 8 slots of 64 pages at
# block_len 8, H = Hkv = 12, D = 64; Tq = 1 is each propose step, 64 the
# catch-up
@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [1, 64])
def test_cuda_paged_attention_at_the_draft_shape(Tq):
    require_cuda()
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops.paged_attention import (TENSOR_CORES,
                                                      paged_attention_cuda,
                                                      paged_attention_plain,
                                                      paged_route)
    lens = (512, 37, 200, 1, 448, 64, 300, 129)
    rows = tuple(range(8)) if Tq == 1 else (1, 3, 6)
    c = paged_inputs(31, B=8, N=8, H=12, Hkv=12, D=64, bl=8, Tq=Tq, ppr=64,
                     pad=64, lens=lens, decode_rows=rows)
    t = lambda a: torch.from_numpy(a).to("cuda", torch.bfloat16)  # noqa
    i = lambda a: torch.from_numpy(a).to("cuda")                   # noqa
    args = (t(c["q"]), t(c["k"]), t(c["v"]), i(c["table"]), i(c["lens"]),
            i(c["q_pos"]), 8, 64, 64 ** -0.5)
    assert paged_route(torch.bfloat16, 8, 64) == TENSOR_CORES
    _kernels.reset_launch_counts()
    out = paged_attention_cuda(*args)
    again = paged_attention_cuda(*args)
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.route_counts()[f"paged_attention:{TENSOR_CORES}"] == 2
    assert torch.equal(out, again)
    assert_bf16_attention_close(out.float().cpu().numpy(),
                                ref.float().cpu().numpy())
