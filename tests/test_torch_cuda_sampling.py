"""The sampling slice on a GPU against the port's own CPU path.

These tests need an NVIDIA GPU and skip without one; they import no JAX
(the CPU side is held to jax.random by tests/test_torch_threefry.py and
tests/test_torch_sampling.py), so they run where only PyTorch exists:

    python -m pytest --noconftest tests/test_torch_cuda_sampling.py -q

At the serve cell's shapes (gpt3-1.3b's vocabulary of 50304; [8, V] and
[512, V] draws; select_tokens over [8, 64, V]) and with chip_smoke.py's
limits, whose `sampling` phase runs the same checks: threefry lane keys,
fold_in, split and random bits bit-equal to the CPU's, gumbel noise
within GUMBEL_ULPS, select_tokens's tokens and DFA states equal, and
`generate(do_sample=True)` on the card equal to itself on the CPU for a
small model.
"""
import numpy as np
import pytest
import torch

from _torch_port import require_cuda

VOCAB = 50304


@pytest.mark.cuda
def test_cuda_threefry_lanes_equal_cpu():
    require_cuda()
    import chip_smoke
    words, ulps = chip_smoke.lane_mismatches(torch, VOCAB)
    assert set(words.values()) == {0}, words
    assert ulps <= chip_smoke.GUMBEL_ULPS


@pytest.mark.cuda
def test_cuda_select_tokens_equal_cpu():
    require_cuda()
    import chip_smoke
    toks, states = chip_smoke.select_case(torch, VOCAB, "cuda")
    toks_cpu, states_cpu = chip_smoke.select_case(torch, VOCAB, "cpu")
    assert torch.equal(toks, toks_cpu)
    assert torch.equal(states, states_cpu)
    assert int(states[5]) > 0 and int(states[6]) > 0      # constrained rows


@pytest.mark.cuda
def test_cuda_sampling_stays_on_the_card():
    require_cuda()
    # a CUDA logits tensor is sampled on the card or the call raises:
    # keys on another device are refused, not moved behind the caller's
    # back
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.models.generation import _select_token
    lg = torch.randn((4, 512), device="cuda")
    key = threefry.prng_key(3)
    with pytest.raises(RuntimeError):
        _select_token(lg, True, 1.0, 0, key)          # key on the CPU
    tok = _select_token(lg, True, 1.0, 0, key.cuda())
    assert tok.is_cuda
    np.testing.assert_array_equal(
        tok.cpu().numpy(), _select_token(lg.cpu(), True, 1.0, 0, key).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(temperature=0.8, top_k=50),
                                   dict(temperature=1.0, top_p=0.9),
                                   dict(temperature=0.7, top_k=40,
                                        top_p=0.95)])
def test_cuda_sampled_generate_equals_cpu(knobs):
    require_cuda()
    # fp32 gpt2-tiny (2 heads of 64: the card's paged kernels take head
    # dims 64 and 128) on the card and on the CPU with the same weights:
    # the sampled streams agree token for token
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator().manual_seed(0)
    cpu = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                     dtype="float32", generator=gen,
                                     num_attention_heads=2)
    card = GPTForCausalLM.from_preset("gpt2-tiny", device="cuda",
                                      dtype="float32",
                                      num_attention_heads=2)
    card.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(1).randint(0, 512, (3, 9)).astype(np.int32)
    a = generate(card, ids, max_new_tokens=12, do_sample=True, seed=5,
                 **knobs)
    b = generate(cpu, ids, max_new_tokens=12, do_sample=True, seed=5,
                 **knobs)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
