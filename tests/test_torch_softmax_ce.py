"""The chunked lm-head + cross-entropy in the PyTorch port against the JAX
package's `fused_linear_cross_entropy`.

Per-token losses and the gradients of h and w, fp32, with labels that
hold ignore_index (-100) and vocabularies that no chunk count divides
(the padded columns are masked to -inf): atol = rtol = 1e-5 for losses
and 1e-5 for gradients (sums over at most 97 columns or 48 rows in
another order). A bf16 case holds the fp32 result of the logits product
(the JAX `preferred_element_type`): its losses stay within 1e-3 of the
fp32 loss of the same bf16 operands, where a bf16-rounded product would
be off by ~1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _data(seed, N, H, V, ignore_every=5):
    rng = np.random.RandomState(seed)
    h = rng.standard_normal((N, H)).astype(np.float32)
    w = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    y = rng.randint(0, V, (N,)).astype(np.int32)
    y[::ignore_every] = -100
    return h, w, y


@pytest.mark.parametrize("N,H,V,n_chunks", [
    (48, 32, 97, 8),       # 97 = 8 x 13 - 7: the last chunk is padded
    (48, 32, 96, 4),       # divides evenly
    (20, 16, 50, 3),
    (12, 8, 31, 1),        # one chunk
])
def test_loss_and_grads_match_jax(N, H, V, n_chunks):
    from paddle_tpu.ops.softmax_ce import fused_linear_cross_entropy as jce
    from paddle_tpu_torch.ops.softmax_ce import fused_linear_cross_entropy
    h, w, y = _data(0, N, H, V)
    gl = np.random.RandomState(1).standard_normal((N,)).astype(np.float32)

    def jloss(h_, w_):
        return jnp.sum(jce(h_, w_, jnp.asarray(y), -100, n_chunks)
                       * jnp.asarray(gl))

    want = np.asarray(jce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                          -100, n_chunks))
    wdh, wdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                               jnp.asarray(w))
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    loss = fused_linear_cross_entropy(ht, wt, torch.from_numpy(y), -100,
                                      n_chunks)
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    np.testing.assert_allclose(loss.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    assert not loss.detach().numpy()[::5].any()      # ignored tokens: 0
    loss.backward(torch.from_numpy(gl))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(wdh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(wdw), atol=1e-5,
                               rtol=1e-5)


def test_equals_dense_softmax_cross_entropy():
    """Against the unfused product + log-softmax in plain torch."""
    from paddle_tpu_torch.ops.softmax_ce import fused_linear_cross_entropy
    h, w, y = _data(2, 30, 16, 61)
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    yt = torch.from_numpy(y).long()
    dense = torch.nn.functional.cross_entropy(ht @ wt, yt,
                                              ignore_index=-100,
                                              reduction="none")
    got = fused_linear_cross_entropy(ht, wt, yt, -100, 4)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_bf16_operands_give_fp32_logits():
    from paddle_tpu.ops.softmax_ce import fused_linear_cross_entropy as jce
    from paddle_tpu_torch.ops.softmax_ce import fused_linear_cross_entropy
    h, w, y = _data(3, 32, 64, 200)
    hb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (h, w))
    want = np.asarray(jce(hb, wb, jnp.asarray(y), -100, 8))
    tb = lambda a: torch.from_numpy(                   # noqa: E731
        np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    ht, wt = tb(hb), tb(wb)
    got = fused_linear_cross_entropy(ht, wt, torch.from_numpy(y), -100, 8)
    exact = fused_linear_cross_entropy(ht.float(), wt.float(),
                                       torch.from_numpy(y), -100, 8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)
    # the gradient comes back in the operands' dtype
    ht.requires_grad_()
    wt.requires_grad_()
    fused_linear_cross_entropy(ht, wt, torch.from_numpy(y), -100,
                               8).mean().backward()
    assert ht.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.bfloat16
