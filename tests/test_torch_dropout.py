"""Dropout in the PyTorch port: the kernels' Philox keep-mask, the dropout
arithmetic of the flash plain versions against the JAX package, and
`nn.functional.dropout` / `nn.Dropout` against the JAX ones.

The TPU PRNG's bits (the JAX kernels' `_block_keep`) and JAX's threefry
cannot be reproduced, so parity is split in three: the port's Philox is
Random123's Philox4x32-10 (known-answer vectors) and keeps 1 - p of the
elements; given the same keep-mask, the port's plain versions compute
what the JAX reference computes; and a model with dropout trains and its
eval logits equal the JAX model's.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# Random123's known-answer vectors for Philox4x32-10 (kat_vectors):
# counter, key -> output words
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def _qkv(seed, B, H, Sq, Sk, D):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D),
                      (B, H, Sq, D))]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answer_vectors(counter, key, want):
    from paddle_tpu_torch.ops.attention import philox4x32_10
    c = [torch.tensor([w], dtype=torch.int64) for w in counter]
    got = philox4x32_10(*c, *key)
    assert [int(w) for w in got] == list(want)


def test_philox_multiply_high_takes_the_full_32_bits():
    """The plain multiply-high splits the 32-bit operand in 16-bit halves:
    against Python's exact integers at the extremes."""
    from paddle_tpu_torch.ops.attention import _mulhilo
    a = torch.tensor([0, 1, 0xffff, 0x10000, 0xdeadbeef, 0xffffffff],
                     dtype=torch.int64)
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = _mulhilo(a, m)
        for x, h, lw in zip(a.tolist(), hi.tolist(), lo.tolist()):
            assert (h, lw) == divmod(x * m, 1 << 32)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_five_sigma(p):
    from paddle_tpu_torch.ops.attention import dropout_keep_mask
    keep = dropout_keep_mask(12345, 4, 4, 256, 256, p)     # 1,048,576
    n = keep.numel()
    assert n >= 10 ** 6
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(float(keep.float().mean()) - (1 - p)) < 5 * sigma


def test_keep_mask_is_keyed_per_element_not_per_tile():
    """The bit of (bh, i, j) does not depend on the shape it is drawn in:
    a smaller draw is a corner of a larger one (so the forward, dq and
    dk/dv kernels, whatever their tiles, regenerate the same mask); seeds
    above 2**32 use the key's high word; another seed gives another
    mask."""
    from paddle_tpu_torch.ops.attention import dropout_keep_mask
    seed = (7 << 32) + 99
    big = dropout_keep_mask(seed, 2, 3, 70, 130, 0.3)
    small = dropout_keep_mask(seed, 2, 3, 33, 61, 0.3)
    np.testing.assert_array_equal(small.numpy(), big[:, :, :33, :61].numpy())
    # bh = b*H + h: B=1, H=6 holds the same rows as B=2, H=3
    flat = dropout_keep_mask(seed, 1, 6, 70, 130, 0.3)
    np.testing.assert_array_equal(flat.reshape(2, 3, 70, 130).numpy(),
                                  big.numpy())
    low = dropout_keep_mask(99, 2, 3, 70, 130, 0.3)
    assert not torch.equal(low, big)
    assert not torch.equal(dropout_keep_mask(seed + 1, 2, 3, 70, 130, 0.3),
                           big)


def test_keep_mask_element_formula():
    """Element (bh, i, j) is word j & 3 of Philox(counter=(j >> 2, i, bh,
    0), key=(seed low, seed high)) compared with int(p * (2**32 - 1))."""
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                philox4x32_10)
    seed, p = (3 << 32) + 17, 0.4
    keep = dropout_keep_mask(seed, 1, 2, 5, 9, p)
    thresh = int(p * (2 ** 32 - 1))
    for bh, i, j in ((0, 0, 0), (1, 4, 8), (1, 2, 6), (0, 3, 5)):
        c = [torch.tensor([x], dtype=torch.int64) for x in (j >> 2, i, bh, 0)]
        w = philox4x32_10(*c, seed & 0xffffffff, seed >> 32)[j & 3]
        assert bool(keep[0, bh, i, j]) == (int(w) >= thresh)


@pytest.mark.parametrize("causal,Sq,Sk", [(False, 16, 24), (True, 24, 24),
                                          (True, 12, 20)])
def test_dropout_arithmetic_matches_the_jax_reference(causal, Sq, Sk):
    """The port's plain forward fed JAX's own keep-mask
    (bernoulli(PRNGKey(s), 1 - p)) equals the JAX reference's dropout."""
    from paddle_tpu.ops.attention import _attention_reference as jax_ref
    from paddle_tpu_torch.ops.attention import flash_fwd_plain
    q, k, v, _ = _qkv(11, 2, 2, Sq, Sk, 16)
    p, scale = 0.25, 0.25
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p, (2, 2, Sq, Sk)))
    ref = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v)), causal,
                             scale, dropout_p=p, dropout_key=key))
    out, _ = flash_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal, scale, keep=torch.from_numpy(keep),
                             dropout_p=p)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_plain_backward_equals_autograd(causal):
    """The plain dq, dk, dv with a keep-mask (the dq and dk/dv kernels'
    formulas) equal autograd through the reference formula with that
    mask."""
    from paddle_tpu_torch.ops.attention import (_attention_reference,
                                                dropout_keep_mask,
                                                flash_attention_delta,
                                                flash_bwd_plain,
                                                flash_fwd_plain)
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(12, 1, 3, 20, 28, 16))
    p, scale = 0.2, 0.25
    keep = dropout_keep_mask(5, 1, 3, 20, 28, p)
    out, lse = flash_fwd_plain(q, k, v, causal, scale, keep=keep,
                               dropout_p=p)
    got = flash_bwd_plain(q, k, v, g, lse, flash_attention_delta(g, out),
                          causal, scale, keep=keep, dropout_p=p)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = _attention_reference(*leaves, causal, scale, dropout_p=p,
                               keep=keep)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=1e-5,
                               rtol=1e-5)
    ref.backward(g)
    for a, t in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("causal,Sq,Sk,with_mask", [
    (False, 16, 24, False), (True, 24, 24, False), (True, 12, 20, True),
    (False, 20, 20, True)])
def test_dropout_plain_backward_matches_jax_grad(causal, Sq, Sk, with_mask):
    """The dq and dk/dv kernels' dropout arithmetic (dp dropped, ds with
    the undropped p, dV with the dropped p), fed JAX's own keep-mask
    (bernoulli(PRNGKey(s), 1 - p)), against jax.grad of the JAX reference
    with that key. With a mask too: `_mask_grad`'s dmask, and autograd
    through the port's reference (the route mask + dropout takes), against
    jax.grad in the mask. atol = rtol = 1e-5."""
    from paddle_tpu.ops.attention import _attention_reference as jax_ref
    from paddle_tpu_torch.ops.attention import (_attention_reference,
                                                _mask_grad,
                                                flash_attention_delta,
                                                flash_bwd_plain,
                                                flash_fwd_plain)
    q, k, v, g = _qkv(14, 2, 2, Sq, Sk, 16)
    mask = (np.random.RandomState(15).standard_normal((2, 1, Sq, Sk))
            .astype(np.float32) if with_mask else None)
    p, scale = 0.25, 0.25
    key = jax.random.PRNGKey(9)
    keep = torch.from_numpy(np.asarray(
        jax.random.bernoulli(key, 1.0 - p, (2, 2, Sq, Sk))))

    def loss(q_, k_, v_, m_):
        out = jax_ref(q_, k_, v_, causal, scale, m_, dropout_p=p,
                      dropout_key=key)
        return jnp.sum(out * jnp.asarray(g))

    argnums = (0, 1, 2, 3) if with_mask else (0, 1, 2)
    want = [np.asarray(w) for w in jax.grad(loss, argnums)(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask))]

    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    mt = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_fwd_plain(qt, kt, vt, causal, scale, mt, keep, p)
    delta = flash_attention_delta(gt, out)
    got = list(flash_bwd_plain(qt, kt, vt, gt, lse, delta, causal, scale,
                               mt, keep, p))
    if with_mask:
        got.append(_mask_grad(qt, kt, vt, mt, lse, gt, delta, causal, scale,
                              keep, p))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5, rtol=1e-5)
    if with_mask:
        leaves = [t.clone().requires_grad_() for t in (qt, kt, vt, mt)]
        ref = _attention_reference(*leaves[:3], causal, scale, leaves[3], p,
                                   keep)
        ref.backward(gt)
        for t, w in zip(leaves, want):
            np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5,
                                       rtol=1e-5)


def test_dropout_is_unbiased_over_seeds():
    """As tests/test_attention.py holds the JAX reference: the mean over
    32 seeds approaches the dropless output, and one draw differs."""
    from paddle_tpu_torch.ops.attention import flash_attention
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(13, 2, 2, 64, 64, 16))
    out0 = flash_attention(q, k, v, causal=False)
    outs = [flash_attention(q, k, v, causal=False, dropout_p=0.3,
                            dropout_seed=s) for s in range(32)]
    np.testing.assert_allclose(torch.stack(outs).mean(0).numpy(),
                               out0.numpy(), rtol=0.35, atol=0.35)
    assert float((outs[0] - out0).abs().max()) > 1e-3
    again = flash_attention(q, k, v, causal=False, dropout_p=0.3,
                            dropout_seed=0)
    assert torch.equal(again, outs[0])


# ---- nn.functional.dropout and nn.Dropout
def _x(seed=0, shape=(64, 96)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p,training", [(0.3, False), (0.0, True),
                                        (1.0, True), (0.0, False)])
def test_functional_dropout_deterministic_cases_equal_jax(mode, p,
                                                          training):
    """Eval and p = 0 are the identity (downscale_in_infer's eval scales
    by 1 - p) and p = 1 gives zeros, as the JAX function does."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as F
    x = _x()
    want = JF.dropout(paddle.to_tensor(x), p, training=training,
                      mode=mode).numpy()
    got = F.dropout(torch.from_numpy(x), p, training=training, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_functional_dropout_keeps_and_scales(mode):
    """Kept elements are x / (1 - p) (upscale) or x (downscale), the rest
    0, at a keep rate within 5 sigma of 1 - p."""
    from paddle_tpu_torch.nn import functional as F
    x = torch.from_numpy(_x(1, (512, 512))) + 10.0   # never 0
    p = 0.3
    y = F.dropout(x, p, training=True, mode=mode)
    kept = y != 0
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] * scale).numpy(),
                               rtol=1e-6)
    n = x.numel()
    assert abs(float(kept.float().mean()) - (1 - p)) < 5 * math.sqrt(
        p * (1 - p) / n)


@pytest.mark.parametrize("axis", [0, 1, [0, 2]])
def test_functional_dropout_axis_broadcasts_as_jax(axis):
    """`axis` names the dims that get their own draw; the others share it
    (the JAX function's shape rule): each slice along the shared dims is
    kept or dropped whole."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as F
    x = np.abs(_x(2, (6, 5, 40))) + 1.0
    got = F.dropout(torch.from_numpy(x), 0.5, axis=axis).numpy() != 0
    want = JF.dropout(paddle.to_tensor(x), 0.5, axis=axis).numpy() != 0
    axes = [axis] if isinstance(axis, int) else axis
    shared = tuple(d for d in range(3) if d not in axes)
    for mask in (got, want):
        assert (mask.all(axis=shared) | ~mask.any(axis=shared)).all()
        assert 0 < mask.mean() < 1


def test_dropout2d_and_3d_drop_whole_channels():
    from paddle_tpu_torch.nn import functional as F
    x = torch.ones(8, 16, 5, 5)
    y = F.dropout2d(x, 0.5)
    per = (y != 0).float().mean(dim=(2, 3))
    assert set(per.unique().tolist()) <= {0.0, 1.0}
    y3 = F.dropout3d(torch.ones(4, 8, 3, 3, 3), 0.5)
    per3 = (y3 != 0).float().mean(dim=(2, 3, 4))
    assert set(per3.unique().tolist()) <= {0.0, 1.0}


def test_seed_repeats_the_draws():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core.random import next_seed
    from paddle_tpu_torch.nn import functional as F
    x = torch.ones(100, 100)
    ptt.seed(3)
    a, s1 = F.dropout(x, 0.5), next_seed()
    ptt.seed(3)
    b, s2 = F.dropout(x, 0.5), next_seed()
    assert torch.equal(a, b) and s1 == s2
    assert not torch.equal(a, F.dropout(x, 0.5))
    assert 0 <= s1 < 2 ** 63 and next_seed() != s1


def test_dropout_layer_train_and_eval():
    from paddle_tpu_torch.nn import Dropout
    layer = Dropout(0.5, mode="downscale_in_infer")
    x = torch.ones(50, 50)
    y = layer(x)
    assert bool(((y == 0) | (y == 1)).all()) and 0 < float(y.mean()) < 1
    layer.eval()
    np.testing.assert_array_equal(layer(x).numpy(), 0.5 * np.ones((50, 50)))
    assert torch.equal(Dropout(0.5).eval()(x), x)


def test_gpt_with_hidden_dropout_trains_and_evaluates_as_jax():
    """gpt2-tiny with hidden_dropout_prob=0.1: a training step gives a
    finite loss and nonzero gradients everywhere; its eval logits equal
    the JAX model's (dropout is the identity in eval)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    paddle.seed(0)
    jm = JaxGPT.from_preset("gpt2-tiny", hidden_dropout_prob=0.1)
    params, _ = jm.functional_state()
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                    hidden_dropout_prob=0.1)
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()})
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int64)
    tm.train()
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert torch.isfinite(loss)
    loss.backward()
    grads = [p.grad for p in tm.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) > 0 for g in grads) == len(grads)
    with torch.no_grad():
        again = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert float(again) != float(loss)      # a fresh draw per call
    tm.eval()
    jm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).data)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
