"""GPT's cached-decode path in the PyTorch port against the JAX package.

The JAX gpt2-tiny weights are bridged into the port (`load_jax_state`);
`forward_with_cache` logits must agree at atol 1e-4 with a scalar `pos`,
a per-row `pos` vector and `paged=` block tables, and greedy
`generate()` must give the same tokens as the JAX
`models.generation.generate` function — with and without an EOS early
stop, `_last_decode_steps` included. (The JAX `GPTForCausalLM.generate`
method passes its arguments into the wrong parameters; the tests call
the JAX function.)
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import tiny_models

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _jax_prefill(jm, ids, caches, pos, paged=None):
    from paddle_tpu.models.generation import make_decoder_fns
    params, prefill, _ = make_decoder_fns(jm)
    logits, new = prefill(params, jnp.asarray(ids), caches, pos, paged=paged)
    return np.asarray(logits), new


def _jax_caches(jm, B, L):
    return [(k.data, v.data) if hasattr(k, "data") else (k, v)
            for k, v in jm.init_cache(B, L)]


def test_forward_with_cache_scalar_pos(models):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, 512, (2, 7)).astype(np.int32)
    ref, _ = _jax_prefill(jm, ids, _jax_caches(jm, 2, 24), jnp.int32(3))
    out, _ = tm.forward_with_cache(torch.from_numpy(ids),
                                   tm.init_cache(2, 24), 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_forward_with_cache_vector_pos_two_steps(models):
    """Per-row offsets over a cache already holding a prefix: the second
    call reads the KV the first one wrote."""
    jm, tm = models
    rng = np.random.RandomState(1)
    a = rng.randint(0, 512, (3, 5)).astype(np.int32)
    bb = rng.randint(0, 512, (3, 2)).astype(np.int32)
    pos = np.array([0, 4, 9], np.int32)
    jc = _jax_caches(jm, 3, 24)
    _, jc = _jax_prefill(jm, a, jc, jnp.asarray(pos))
    ref, _ = _jax_prefill(jm, bb, jc, jnp.asarray(pos + 5))
    tc = tm.init_cache(3, 24)
    _, tc = tm.forward_with_cache(torch.from_numpy(a), tc,
                                  torch.from_numpy(pos))
    out, _ = tm.forward_with_cache(torch.from_numpy(bb), tc,
                                   torch.from_numpy(pos + 5))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_forward_with_cache_paged(models):
    """The serving step's form: slab rows with chunk write-padding, per-row
    positions, block tables and ragged seq_lens."""
    jm, tm = models
    rng = np.random.RandomState(2)
    N, bl, nb, C = 3, 8, 4, 6
    L = nb * bl + C
    toks = rng.randint(0, 512, (N, C)).astype(np.int32)
    pos = np.array([0, 3, nb * bl], np.int32)         # last: a free row
    adv = np.array([6, 2, 0], np.int32)
    table = (np.arange(N, dtype=np.int32)[:, None] * nb
             + np.arange(nb, dtype=np.int32)[None])
    seq = (pos + adv).astype(np.int32)
    ref, _ = _jax_prefill(jm, toks, _jax_caches(jm, N, L),
                          jnp.asarray(pos),
                          paged=(jnp.asarray(table), jnp.asarray(seq), bl,
                                 nb))
    out, _ = tm.forward_with_cache(
        torch.from_numpy(toks), tm.init_cache(N, L), torch.from_numpy(pos),
        paged=(torch.from_numpy(table), torch.from_numpy(seq), bl, nb))
    for r in range(N):      # real columns only; the rest are discarded
        n = int(adv[r])
        np.testing.assert_allclose(out.numpy()[r, :n], ref[r, :n],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,S0,new", [(2, 11, 9), (1, 3, 6)])
def test_generate_matches_jax(models, B, S0, new):
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu_torch.models.generation import generate
    jm, tm = models
    ids = np.random.RandomState(B + S0).randint(0, 512, (B, S0)).astype(
        np.int32)
    ref = np.asarray(jax_generate(jm, ids, max_new_tokens=new).data)
    out = generate(tm, ids, max_new_tokens=new)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tm._last_decode_steps == jm._last_decode_steps == new - 1


def test_generate_eos_padding_and_early_stop(models):
    from paddle_tpu.models.generation import generate as jax_generate
    from paddle_tpu_torch.models.generation import generate
    jm, tm = models
    ids = np.random.RandomState(7).randint(0, 512, (2, 6)).astype(np.int32)
    free = np.asarray(jax_generate(jm, ids, max_new_tokens=10).data)
    # EOS = row 0's 4th new token: row 0 stops there and pads with EOS
    eos = int(free[0, 6 + 3])
    ref = np.asarray(jax_generate(jm, ids, max_new_tokens=10,
                                  eos_token_id=eos).data)
    out = generate(tm, ids, max_new_tokens=10, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out, ref)
    assert tm._last_decode_steps == jm._last_decode_steps
    # one row: the loop stops as soon as it emits EOS
    ref1 = np.asarray(jax_generate(jm, ids[:1], max_new_tokens=10,
                                   eos_token_id=eos).data)
    out1 = generate(tm, ids[:1], max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(out1.numpy(), ref1)
    assert tm._last_decode_steps == jm._last_decode_steps == 3


def test_method_generate_passes_keywords(models):
    """The port's GPTForCausalLM.generate binds by keyword, so it equals
    the generate() function (the JAX method would treat token 0 as EOS)."""
    from paddle_tpu_torch.models.generation import generate
    _, tm = models
    ids = np.array([[5, 6, 7]], np.int32)
    np.testing.assert_array_equal(tm.generate(ids, max_new_tokens=5),
                                  generate(tm, ids, max_new_tokens=5))


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
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    _, tm = models
    drop = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                      hidden_dropout_prob=0.1)
    drop.train()
    with pytest.raises(NotImplementedError, match="dropout"):
        drop(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="sampling"):
        generate(tm, np.zeros((1, 2), np.int32), do_sample=True)
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
