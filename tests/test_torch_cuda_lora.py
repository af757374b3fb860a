"""Multi-LoRA on the card (`cuda` marker; skipped without a GPU), at
gpt2-tiny's widths with 2 heads of 64, bf16:

- `lora_delta` on the card within 1e-5 of its CPU run in fp32 (the same
  products, cuBLAS's order), a bank row 0 exact zeros, and
  `add_lora_delta` leaving a bf16 y bit-equal there;
- an armed `LLMEngine`: its base streams bit-equal to an unarmed
  engine's (the same step widths; row 0's delta is exact zeros and the
  add keeps y's dtype), every stream bit-equal with the bank's rows
  permuted (each row gathers its own adapter, whatever row it sits in),
  and each adapter moving a token;
- a hot swap from another thread between two layers of a step: every row
  of that step equal to the all-old run's (the bank writes copy-on-write
  and the step holds one version).

No JAX here: on the card's machine run it with `python -m pytest
--noconftest`.
"""
import threading

import numpy as np
import pytest
import torch

from _torch_port import adapter_tree, require_cuda


def _gpt(device, dtype="bfloat16"):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return GPTForCausalLM.from_preset("gpt2-tiny", device=device, dtype=dtype,
                                      generator=gen, num_attention_heads=2)


CFG = dict(num_slots=4, block_len=8, n_blocks=8, prefill_chunk=16,
           enable_prefix_cache=False)


@pytest.mark.cuda
def test_cuda_lora_delta_matches_cpu():
    require_cuda()
    from paddle_tpu_torch.ops.lora import add_lora_delta, lora_delta
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16, 128).astype(np.float32)
    A = rng.randn(4, 8, 128).astype(np.float32)
    B = rng.randn(4, 384, 8).astype(np.float32)
    A[0], B[0] = 0.0, 0.0
    idx = np.array([0, 3, 1, 2], np.int64)
    scale = np.array([0.0, 2.0, 0.5, 1.0], np.float32)
    cpu = lora_delta(*map(torch.from_numpy, (x, A, B, idx, scale)))
    card = lora_delta(*(torch.from_numpy(a).cuda()
                        for a in (x, A, B, idx, scale)))
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-5, rtol=1e-5)
    assert not card[0].any()
    y = torch.randn(4, 16, 384, device="cuda").to(torch.bfloat16)
    out = add_lora_delta(y, torch.from_numpy(x).cuda().to(torch.bfloat16),
                         (torch.from_numpy(A).cuda(),
                          torch.from_numpy(B).cuda()),
                         torch.from_numpy(idx).cuda(),
                         torch.from_numpy(scale).cuda())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0], y[0]) and not torch.equal(out[1], y[1])


def _streams(model, trees, order, route, prompts):
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(model, LLMEngineConfig(
        **CFG, **({"max_adapters": 3, "lora_rank": 4} if trees else {})))
    for aid in order:
        eng.register_adapter(aid, trees[aid])
    hs = [eng.submit(p, max_new_tokens=8, adapter=route[i % len(route)])
          for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.pump()
    return [h.result(0) for h in hs], eng


@pytest.mark.cuda
def test_cuda_armed_engine_base_rows_and_permuted_bank():
    require_cuda()
    model = _gpt("cuda")
    trees = {f"ad{s}": adapter_tree(model, s, sigma=0.3) for s in (1, 2, 3)}
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (9, 30, 17, 41, 5, 24, 12, 33)]
    route = (None, "ad1", "ad2", "ad3")
    plain, _ = _streams(model, {}, (), (None,), prompts)
    armed, eng = _streams(model, trees, ("ad1", "ad2", "ad3"), route,
                          prompts)
    perm, peng = _streams(model, trees, ("ad3", "ad1", "ad2"), route,
                          prompts)
    assert eng.adapter_bank.row_of("ad1") != peng.adapter_bank.row_of("ad1")
    for i in range(len(prompts)):
        np.testing.assert_array_equal(perm[i], armed[i])
        if route[i % 4] is None:
            np.testing.assert_array_equal(armed[i], plain[i])
    for aid in ("ad1", "ad2", "ad3"):
        assert any(not np.array_equal(armed[i], plain[i])
                   for i in range(len(prompts)) if route[i % 4] == aid), aid
    assert eng.pool.check_balance()


@pytest.mark.cuda
def test_cuda_hot_swap_between_layers_does_not_tear_a_step():
    require_cuda()
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    model = _gpt("cuda")
    old, new = (adapter_tree(model, s, sigma=0.3) for s in (1, 9))
    prompt = np.arange(3, 12, dtype=np.int32)

    def first_step(tree, swap=None):
        eng = LLMEngine(model, LLMEngineConfig(**CFG, max_adapters=1,
                                               lora_rank=4))
        eng.register_adapter("ad1", tree)
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
            handle = model.gpt.layers[0].register_forward_hook(hook)
        for a in (None, "ad1"):
            eng.submit(prompt, max_new_tokens=1, adapter=a)
        while eng.has_work():
            eng.pump()
        return logits[0][:, :len(prompt)]

    want_old = first_step(old)
    want_new = first_step(new)
    torn = first_step(old, swap=new)
    assert torch.equal(torn, want_old)
    assert not torch.equal(torn[1], want_new[1])
