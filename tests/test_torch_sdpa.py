"""The attention entry points of the PyTorch port against the JAX package:
`ops.scaled_dot_product_attention` ([B, S, H, D], Paddle's layout) and
`incubate.flash_attention`, with p = 0 in layout and values (fp32, atol =
rtol = 1e-5), with an additive mask, and in training with dropout p > 0
as tests/test_attention.py holds the JAX ones; a mask with dropout takes
the plain reference (the JAX package's rule) and gets its gradient.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _bshd(seed, B=2, S=16, H=4, D=8, Sk=None):
    rng = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, Sk, H, D), (B, Sk, H, D))]


def _jax_sdpa(q, k, v, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.ops import scaled_dot_product_attention
    args = [paddle.to_tensor(a) for a in (q, k, v)]
    if kw.get("attn_mask") is not None:
        kw["attn_mask"] = paddle.to_tensor(kw["attn_mask"])
    return np.asarray(scaled_dot_product_attention(*args, **kw).numpy())


@pytest.mark.parametrize("is_causal,Sk", [(False, 16), (True, 16),
                                          (True, 24), (False, 9)])
def test_sdpa_matches_jax_without_dropout(is_causal, Sk):
    from paddle_tpu_torch.ops import scaled_dot_product_attention
    q, k, v = _bshd(0, Sk=Sk)
    want = _jax_sdpa(q, k, v, is_causal=is_causal)
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=is_causal)
    assert got.shape == (2, 16, 4, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # dropout_p is ignored outside training, as the JAX function does
    off = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), dropout_p=0.5,
        is_causal=is_causal, training=False)
    assert torch.equal(off, got)


@pytest.mark.parametrize("mshape", [(2, 1, 16, 16), (2, 4, 16, 16),
                                    (1, 1, 16, 16), (2, 16, 16)])
def test_sdpa_with_mask_matches_jax(mshape):
    from paddle_tpu_torch.ops import scaled_dot_product_attention
    q, k, v = _bshd(1)
    mask = np.random.RandomState(2).standard_normal(mshape).astype(
        np.float32)
    want = _jax_sdpa(q, k, v, attn_mask=mask)
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_incubate_flash_attention_matches_jax():
    from paddle_tpu.incubate import flash_attention as jax_flash
    from paddle_tpu_torch.incubate import flash_attention
    rng = np.random.RandomState(3)
    q, k, v = (rng.standard_normal((2, 3, 20, 16)).astype(np.float32)
               for _ in range(3))
    mask = np.where(rng.rand(2, 1, 20, 20) < 0.2, -1e9, 0.0).astype(
        np.float32)
    for causal, m in ((True, None), (False, mask), (True, mask)):
        want = np.asarray(jax_flash(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            mask=None if m is None else jnp.asarray(m)))
        got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal,
                              mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_sdpa_dropout_trains():
    """As tests/test_attention.py::test_sdpa_dropout_trains: p > 0 in
    training gives finite gradients; each call draws a fresh seed from
    core.random, and seed() repeats them."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import scaled_dot_product_attention
    x = torch.from_numpy(_bshd(4)[0]).requires_grad_()
    ptt.seed(11)
    out = scaled_dot_product_attention(x, x, x, dropout_p=0.25,
                                       is_causal=True, training=True)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert float(x.grad.abs().sum()) > 0
    with torch.no_grad():
        other = scaled_dot_product_attention(x, x, x, dropout_p=0.25,
                                             is_causal=True)
        ptt.seed(11)
        again = scaled_dot_product_attention(x, x, x, dropout_p=0.25,
                                             is_causal=True)
    assert not torch.equal(other, out)
    assert torch.equal(again, out.detach())


def test_mask_with_dropout_takes_the_plain_reference_with_mask_grad():
    """A mask and dropout together run `_attention_reference` with the
    Philox keep-mask (the JAX package routes the pair to its reference),
    differentiable in the mask: its gradient equals autograd through the
    reference with that keep-mask, and `_mask_grad`'s formula with dp
    dropped."""
    from paddle_tpu_torch.ops.attention import (_attention_reference,
                                                _mask_grad,
                                                dropout_keep_mask,
                                                flash_attention,
                                                flash_attention_delta,
                                                flash_fwd_plain)
    rng = np.random.RandomState(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 2, 12, 16), (2, 2, 12, 16), (2, 2, 12, 16),
                            (2, 2, 12, 16)))
    m = torch.from_numpy(rng.standard_normal((2, 1, 12, 12)).astype(
        np.float32)).requires_grad_()
    p, seed, scale = 0.3, 77, 0.25
    out = flash_attention(q, k, v, causal=True, mask=m, dropout_p=p,
                          dropout_seed=seed)
    out.backward(g)
    keep = dropout_keep_mask(seed, 2, 2, 12, 12, p)
    m2 = m.detach().clone().requires_grad_()
    ref = _attention_reference(q, k, v, True, scale, m2, p, keep)
    ref.backward(g)
    assert torch.equal(out.detach(), ref.detach())
    assert torch.equal(m.grad, m2.grad)
    o, lse = flash_fwd_plain(q, k, v, True, scale, m.detach(), keep, p)
    dm = _mask_grad(q, k, v, m.detach(), lse, g, flash_attention_delta(g, o),
                    True, scale, keep, p)
    np.testing.assert_allclose(dm.numpy(), m.grad.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_mask_shapes_are_checked():
    from paddle_tpu_torch.ops.attention import _mask_3d
    for bad in ((3, 1, 8, 8), (2, 3, 8, 8), (2, 1, 5, 8)):
        with pytest.raises(ValueError, match="mask"):
            _mask_3d(torch.zeros(bad), 2, 4, 8, 8)
    rows, div = _mask_3d(torch.zeros(2, 1, 1, 8), 2, 4, 8, 8)
    assert rows.shape == (2, 8, 8) and div == 4
    rows, div = _mask_3d(torch.zeros(1, 1, 8, 8), 2, 4, 8, 8)
    assert rows.shape == (1, 8, 8) and div == 8
    rows, div = _mask_3d(torch.zeros(2, 4, 8, 8), 2, 4, 8, 8)
    assert rows.shape == (8, 8, 8) and div == 1


def test_kernel_mask_is_laid_out_once():
    """`_kernel_mask` gives the kernels' layout (fp32, contiguous, a
    per-head mask's batch expanded) whose `_mask_3d` is a view, takes a
    mask already in it without a copy, and keeps the values; FlashAttentionFn
    converts a mask through it once a forward."""
    from paddle_tpu_torch.ops.attention import _kernel_mask, _mask_3d
    B, H, Sq, Sk = 2, 4, 8, 8
    rng = np.random.RandomState(6)
    for shape, want in (((2, 1, 1, 8), (2, 1, 8, 8)),
                        ((1, 4, 8, 8), (2, 4, 8, 8)),
                        ((2, 8, 8), (2, 1, 8, 8)),
                        ((1, 1, 8, 1), (1, 1, 8, 8))):
        m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for given in (m, m.bfloat16()):
            laid = _kernel_mask(given, B, H, Sq, Sk)
            assert laid.shape == want and laid.dtype == torch.float32
            assert laid.is_contiguous()
            rows, _ = _mask_3d(laid, B, H, Sq, Sk)
            assert rows.data_ptr() == laid.data_ptr()     # no copy
            again = _kernel_mask(laid, B, H, Sq, Sk)
            assert again.data_ptr() == laid.data_ptr()    # no copy
            full = given.float().reshape(
                (shape[0], 1) + shape[1:] if len(shape) == 3 else shape)
            assert torch.equal(laid, full.expand(want))
    with pytest.raises(ValueError, match="mask"):
        _kernel_mask(torch.zeros(3, 1, 8, 8), B, H, Sq, Sk)
