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
    """The paths still unported raise; training-mode dropout, sampled
    generate() and MoE models, which this test once saw raise, now run
    (tests/test_torch_dropout.py, tests/test_torch_sampling.py and
    tests/test_torch_moe.py hold them to the JAX package). An MoE model's
    cached decode raises with the JAX package's words, as there."""
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
    moe = GPTForCausalLM.from_preset("ernie-moe-tiny", device="cpu")
    assert [layer.use_moe for layer in moe.gpt.layers] == [False, True,
                                                          False, True]
    with pytest.raises(NotImplementedError,
                       match="KV-cache decode is not wired through MoE "
                             "layers yet"):
        moe.forward_with_cache(torch.zeros((1, 2), dtype=torch.long),
                               moe.init_cache(1, 8), 0)


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


# FLAGS_fused_lm_ce=0: the logits through the lm head and
# ParallelCrossEntropy instead of the chunked lm-head + CE, in both
# packages (each reads the flag at every forward). fp32: the loss within
# rtol 1e-5 and every gradient within rtol 1e-4 (each element within 1e-4
# of itself plus 1e-5 of its leaf's largest: the same fp32 sums in another
# order, as tests/test_torch_llama.py holds its gradients), and the
# unfused loss equals the fused one to 1e-5 in the port. Under AMP bf16
# (the lm head in bf16, the CE in fp32): the loss within rtol 4e-3 and
# each leaf's gradient within 2% of its norm (bf16's 2^-8 rounding, taken
# at other places in the two packages).
@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_unfused_lm_ce_loss_and_grads_match_jax(models, monkeypatch, amp):
    import contextlib
    import paddle_tpu as paddle
    from paddle_tpu.amp import auto_cast as jax_cast
    from paddle_tpu_torch.amp import auto_cast
    jm, tm = models
    tm.train()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 512, (2, 24)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    jctx = jax_cast(True, dtype=amp) if amp else contextlib.nullcontext()
    tctx = auto_cast(True, dtype=amp) if amp else contextlib.nullcontext()
    fused = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    monkeypatch.setenv("FLAGS_fused_lm_ce", "0")
    with jctx:
        jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.data, np.float32)
              for k, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()
    tm.zero_grad(set_to_none=True)
    with tctx:
        loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    # bf16 logits: the two packages round the lm head's output at other
    # places, so the loss and gradients get bf16's rounding (2^-8)
    rtol = 1e-5 if amp is None else 4e-3
    np.testing.assert_allclose(float(loss.detach()),
                               float(np.asarray(jloss.data)), rtol=rtol)
    if amp is None:
        np.testing.assert_allclose(float(loss.detach()), float(fused),
                                   rtol=1e-5)
    loss.backward()
    for k, p in tm.named_parameters():
        want = jgrads[k]
        if amp is None:
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=1e-4,
                atol=1e-5 * float(np.abs(want).max()), err_msg=k)
        else:
            # per leaf, as a whole: bf16 rounding moves single elements
            # by up to half of themselves where sums cancel
            err = np.linalg.norm(p.grad.numpy() - want)
            assert err <= 2e-2 * np.linalg.norm(want) + 1e-6, (k, err)
    tm.zero_grad(set_to_none=True)
    tm.eval()
