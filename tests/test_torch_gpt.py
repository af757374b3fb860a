"""GPT's cached-decode path in the PyTorch port against the JAX package.

The JAX gpt2-tiny weights are bridged into the port (`load_jax_state`);
`forward_with_cache` logits must agree at atol 1e-4 with a scalar `pos`,
a per-row `pos` vector and `paged=` block tables, and greedy
`generate()` must give the same tokens as the JAX
`models.generation.generate` function — with and without an EOS early
stop, `_last_decode_steps` included (the cases in `_torch_port.py`,
which the Llama family shares). (The JAX `GPTForCausalLM.generate`
method passes its arguments into the wrong parameters; the tests call
the JAX function.)
"""
import numpy as np
import pytest
import torch

from _torch_port import (check_cache_paged, check_cache_scalar_pos,
                         check_cache_vector_pos_two_steps, check_generate,
                         check_generate_eos, check_generate_method,
                         tiny_models)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_forward_with_cache_scalar_pos(models):
    check_cache_scalar_pos(*models)


def test_forward_with_cache_vector_pos_two_steps(models):
    check_cache_vector_pos_two_steps(*models)


def test_forward_with_cache_paged(models):
    check_cache_paged(*models)


@pytest.mark.parametrize("B,S0,new", [(2, 11, 9), (1, 3, 6)])
def test_generate_matches_jax(models, B, S0, new):
    check_generate(*models, B, S0, new)


def test_generate_eos_padding_and_early_stop(models):
    check_generate_eos(*models)


def test_method_generate_passes_keywords(models):
    check_generate_method(models[1])


def test_bridge_refuses_mismatched_state(models):
    from paddle_tpu_torch.bridge import load_jax_state
    jm, tm = models
    params = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    missing = dict(params)
    missing.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_jax_state(tm, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_state(tm, {**params, "gpt.bogus": np.zeros(1)})
    bad = dict(params)
    bad["gpt.final_norm.bias"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="gpt.final_norm.bias"):
        load_jax_state(tm, bad)


def test_bridge_names_match_functional_state(models):
    jm, tm = models
    assert set(jm.functional_state()[0]) == {
        k for k, _ in tm.named_parameters()}


def test_unported_paths_raise(models):
    """The paths still unported raise; training-mode dropout and sampled
    generate(), which this test once saw raise, now run
    (tests/test_torch_dropout.py and tests/test_torch_sampling.py hold
    them to the JAX package)."""
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    _, tm = models
    drop = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                      hidden_dropout_prob=0.1)
    drop.train()
    logits = drop(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, 512) and torch.isfinite(logits).all()
    out = generate(tm, np.zeros((1, 2), np.int32), do_sample=True)
    assert out.shape == (1, 34) and ((out >= 0) & (out < 512)).all()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.init_cache(1, 513)
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTForCausalLM.from_preset("ernie-moe-tiny", device="cpu")


def test_bf16_model_runs_in_bf16(models):
    """dtype= builds the whole model and its caches in that dtype."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    m = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                   dtype="bfloat16")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    caches = m.init_cache(1, 16)
    assert caches[0][0].dtype == torch.bfloat16
    logits, _ = m.forward_with_cache(torch.tensor([[1, 2, 3]]), caches, 0)
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
