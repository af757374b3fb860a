"""Flash attention in the PyTorch port against the JAX package.

The port's plain versions (what a CPU tensor takes; the CUDA kernels are
held to them on the card in test_torch_cuda_kernels.py) against the JAX
`flash_attention(..., force_pallas=True)` — the Pallas forward, dq and
dk/dv kernels in interpret mode — and against `_attention_reference`:
out, lse and the gradients of q, k and v, causal and not, Sq < Sk, and
Sq > Sk with rows that see no key. fp32 throughout, at atol = rtol = 1e-5
(out, lse: one op sequence, sums of at most 48 products in another
order) and 1e-4 (gradients: three chained products).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

CASES = [  # B, H, Sq, Sk, D, causal
    (2, 2, 32, 32, 16, True),
    (2, 2, 32, 32, 16, False),
    (1, 3, 16, 48, 32, True),       # Sq < Sk: bottom-right offset
    (1, 3, 48, 16, 32, True),       # Sq > Sk: the first 32 rows see no key
    (1, 2, 24, 40, 16, False),
]


def _inputs(seed, B, H, Sq, Sk, D):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    g = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, g


def _jax_grads(fn, q, k, v, g):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * jnp.asarray(g))
    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))


def _port_grads(q, k, v, g, causal):
    from paddle_tpu_torch.ops.attention import flash_attention
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_matches_pallas_kernels_in_interpret_mode(B, H, Sq, Sk, D, causal):
    from paddle_tpu.ops.attention import flash_attention as jax_flash
    q, k, v, g = _inputs(1, B, H, Sq, Sk, D)

    def fn(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal, force_pallas=True)

    ref_out = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    ref_grads = _jax_grads(fn, q, k, v, g)
    out, grads = _port_grads(q, k, v, g, causal)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    if causal and Sq > Sk:                   # rows with no visible key
        assert not out[:, :, :Sq - Sk].any()
        assert not grads[0][:, :, :Sq - Sk].any()


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_matches_xla_reference_and_its_gradients(B, H, Sq, Sk, D, causal):
    from paddle_tpu.ops.attention import _attention_reference as jax_ref
    from paddle_tpu_torch.ops.attention import _attention_reference
    q, k, v, g = _inputs(2, B, H, Sq, Sk, D)
    scale = 1.0 / np.sqrt(D)

    def fn(q_, k_, v_):
        return jax_ref(q_, k_, v_, causal, scale)

    ref_grads = _jax_grads(fn, q, k, v, g)
    out, grads = _port_grads(q, k, v, g, causal)
    ref_out = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    # the port's own reference (autograd through the plain math) agrees too
    plain = _attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal, scale)
    np.testing.assert_allclose(plain.numpy(), ref_out, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,Sq,Sk", [(True, 32, 32), (True, 48, 16),
                                          (False, 24, 40)])
def test_lse_matches_the_pallas_forward(causal, Sq, Sk):
    from paddle_tpu.ops.attention import _flash_fwd
    from paddle_tpu_torch.ops.attention import flash_fwd_plain
    q, k, v, _ = _inputs(3, 1, 2, Sq, Sk, 16)
    scale = 0.25
    jout, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None, causal, scale, 256, 256, 0.0, 0)
    out, lse = flash_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal, scale)
    assert lse.shape == (1, 2, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)


def test_bf16_plain_version_tracks_the_pallas_kernel():
    """bf16 inputs: both sides round p to bf16 before PV and the output to
    bf16 once, from fp32 sums in another order; two bf16 ulps of the
    output's scale (2^-6 at |out| < 2) bound the difference."""
    from paddle_tpu.ops.attention import flash_attention as jax_flash
    from paddle_tpu_torch.ops.attention import flash_attention
    q, k, v, _ = _inputs(4, 1, 2, 64, 64, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, causal=True,
                               force_pallas=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0 ** -6,
                               rtol=0)


def test_mask_takes_the_plain_reference_and_dropout_raises():
    from paddle_tpu.ops.attention import _attention_reference as jax_ref
    from paddle_tpu_torch.ops.attention import flash_attention
    q, k, v, _ = _inputs(5, 1, 2, 16, 16, 16)
    mask = np.zeros((1, 1, 16, 16), np.float32)
    mask[..., :3] = -1e9
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             False, 0.25, mask=jnp.asarray(mask)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_attention(*t, causal=False, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(*t, dropout_p=0.1)


def test_causal_mask_matches_jax():
    from paddle_tpu.ops.attention import causal_mask as jax_mask
    from paddle_tpu_torch.ops.attention import causal_mask
    for rows, cols, qo, ko in ((4, 6, 2, 0), (5, 3, 0, 1), (3, 3, 0, 0)):
        np.testing.assert_array_equal(
            causal_mask(rows, cols, qo, ko).numpy(),
            np.asarray(jax_mask(rows, cols, qo, ko)))
