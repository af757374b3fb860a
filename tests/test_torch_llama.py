"""The Llama family of the PyTorch port against the JAX package.

Every case runs twice on `llama2-tiny`: as the preset gives it (4 query
heads, 4 kv heads) and with `num_key_value_heads=2`, grouped-query
attention, where each kv head must serve its own two query heads
(`repeat_interleave`, which is what `jnp.repeat` computes; tiling the kv
heads instead puts kv head 0 beside query heads 0 and 2, and with one kv
head the two orders could not be told apart). The JAX weights are bridged
into the port (`load_jax_state`), all in fp32 on the CPU:

- no-cache logits within atol 1e-4 (sums over at most 352 terms in
  another order put them ~1e-6 apart);
- the loss with ignored (-100) labels, and every parameter's gradient,
  within rtol 1e-4 (each gradient element within 1e-4 of the larger of
  itself and a tenth of its leaf's largest magnitude);
- GPT's cached-decode cases (`_torch_port.py`): `forward_with_cache`
  logits within atol 1e-4 with a scalar `pos`, a per-row `pos` over two
  calls (the second rotates positions past the first call's tokens) and
  `paged=` block tables; greedy `generate()` tokens equal to the JAX
  `models.generation.generate` function, with and without an EOS early
  stop, `_last_decode_steps` included. (The JAX
  `LlamaForCausalLM.generate` method passes its arguments into the wrong
  parameters; the port's passes keywords.)

Also: the presets equal the JAX ones, the rotary tables and rotation
equal the JAX functions at positions up to the table's end, the unported
paths raise, the bridge's names equal `functional_state()`, and a bf16
model runs in bf16.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import (CACHE_ATOL, check_cache_paged,
                         check_cache_scalar_pos,
                         check_cache_vector_pos_two_steps, check_generate,
                         check_generate_eos, check_generate_method,
                         tiny_models)

GRAD_RTOL = 1e-4
FORMS = {"mha": {}, "gqa": {"num_key_value_heads": 2}}


@pytest.fixture(scope="module", params=sorted(FORMS))
def models(request):
    return tiny_models("llama2-tiny", **FORMS[request.param])


def _ids(seed, B, S):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(
        np.int32)


def test_presets_match_jax():
    from paddle_tpu.models.llama import LLAMA_PRESETS as JAX_PRESETS
    from paddle_tpu_torch.models.llama import LLAMA_PRESETS
    assert set(LLAMA_PRESETS) == set(JAX_PRESETS)
    for name, cfg in LLAMA_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_PRESETS[name])
        assert cfg.head_dim == JAX_PRESETS[name].head_dim


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    """The fp32 tables at every position of llama2-tiny's 512, and the
    rotation with shared [S, D] or per-row [B, S, D] angles."""
    from paddle_tpu.models.llama import _apply_rope as jax_rope
    from paddle_tpu.models.llama import _rope_cos_sin as jax_tables
    from paddle_tpu_torch.models.llama import _apply_rope, _rope_cos_sin
    cos, sin = _rope_cos_sin(512, 32, 10000.0)
    jcos, jsin = (np.array(a) for a in jax_tables(512, 32, 10000.0))
    assert cos.dtype == torch.float32 and cos.shape == (512, 32)
    np.testing.assert_allclose(cos.numpy(), jcos, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sin.numpy(), jsin, atol=1e-5, rtol=0)
    x = np.random.RandomState(0).standard_normal((2, 3, 5, 32)).astype(
        np.float32)
    if per_row:
        rows = np.array([[0, 1, 2, 3, 4], [507, 508, 509, 510, 511]])
        c, s = jcos[rows], jsin[rows]
    else:
        c, s = jcos[100:105], jsin[100:105]
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(c),
                               jnp.asarray(s)))
    got = _apply_rope(torch.from_numpy(x), torch.from_numpy(c),
                      torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_forward_logits_match_jax(models):
    import paddle_tpu as paddle
    jm, tm = models
    ids = _ids(0, 2, 19)
    want = np.asarray(jm(paddle.to_tensor(ids)).data)
    got = tm(torch.from_numpy(ids))
    assert got.shape == (2, 19, 512)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=CACHE_ATOL,
                               rtol=0)


def test_loss_and_grads_match_jax(models):
    import paddle_tpu as paddle
    jm, tm = models
    ids = _ids(1, 2, 16)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :5] = -100
    jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.data) for k, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()
    tm.zero_grad(set_to_none=True)
    loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss.detach()),
                               float(np.asarray(jloss.data)),
                               rtol=GRAD_RTOL, atol=0)
    loss.backward()
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(jgrads)
    for k, want in jgrads.items():
        np.testing.assert_allclose(
            got[k], want, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * 0.1 * float(np.abs(want).max()), err_msg=k)
    tm.zero_grad(set_to_none=True)


def test_forward_with_cache_scalar_pos(models):
    check_cache_scalar_pos(*models)


def test_forward_with_cache_vector_pos_two_steps(models):
    check_cache_vector_pos_two_steps(*models)


def test_forward_with_cache_paged(models):
    check_cache_paged(*models)


def test_generate_matches_jax(models):
    check_generate(*models, 2, 11, 9)


def test_generate_eos_early_stop(models):
    check_generate_eos(*models)


def test_method_generate_passes_keywords(models):
    check_generate_method(models[1])


def test_unported_paths_raise(models):
    """The paths still unported raise; sampled generate() and the cached
    forward with `adapters=`, which this test once saw raise, now run
    (tests/test_torch_sampling.py and tests/test_torch_lora_models.py hold
    them to the JAX package): a bank of zero rows leaves the logits
    bit-equal."""
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.serving.llm.lora import AdapterBank
    _, tm = models
    h = torch.zeros((1, 3, 128))
    with pytest.raises(NotImplementedError, match="padding masks"):
        tm.llama.layers[0].self_attn(h, None,
                                     attn_mask=torch.zeros((1, 3, 3)))
    ids = torch.tensor([[5, 6]])
    bank = AdapterBank(tm, max_adapters=1, rank=2, num_slots=1)
    plain, _ = tm.forward_with_cache(ids, tm.init_cache(1, 8), 0)
    armed, _ = tm.forward_with_cache(ids, tm.init_cache(1, 8), 0,
                                     adapters=bank.device_args())
    assert torch.equal(plain, armed)
    out = generate(tm, np.zeros((1, 2), np.int32), do_sample=True)
    assert out.shape == (1, 34) and ((out >= 0) & (out < 512)).all()
    for name, args in (("pipe_layer_prefixes", ()), ("pipe_layers", ()),
                       ("pipe_embed", (h,)), ("pipe_logits", (h,)),
                       ("pipe_head", (h, h))):
        with pytest.raises(NotImplementedError, match="pipeline"):
            getattr(tm, name)(*args)


def test_bridge_names_match_functional_state(models):
    jm, tm = models
    assert set(jm.functional_state()[0]) == {
        k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        assert tuple(p.shape) == tuple(jm.functional_state()[0][k].shape)


def test_bf16_model_runs_in_bf16(models):
    """dtype= builds the whole model and its caches in that dtype; the
    rotary angles are cast to bf16 before rotating; the loss is fp32."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    _, tm = models
    m = LlamaForCausalLM.from_preset(
        "llama2-tiny", device="cpu", dtype="bfloat16",
        num_key_value_heads=tm.config.num_key_value_heads)
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    caches = m.init_cache(1, 16)
    assert caches[0][0].dtype == torch.bfloat16
    cos, sin = m.llama._rope(caches[0][0], 16, 3, 2)
    assert cos.dtype == sin.dtype == torch.bfloat16 and cos.shape == (3, 32)
    logits, _ = m.forward_with_cache(torch.tensor([[1, 2, 3]]), caches, 0)
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    ids = torch.tensor([[1, 2, 3, 4]])
    loss = m(ids, ids)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
