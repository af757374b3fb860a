"""Flash attention in the PyTorch port against the JAX package.

The port's plain versions (what a CPU tensor takes; the CUDA kernels are
held to them on the card in test_torch_cuda_kernels.py) against the JAX
`flash_attention(..., force_pallas=True)` — the Pallas forward, dq and
dk/dv kernels in interpret mode — and against `_attention_reference`:
out, lse and the gradients of q, k and v, causal and not, Sq < Sk, and
Sq > Sk with rows that see no key. fp32 throughout, at atol = rtol = 1e-5
(out, lse: one op sequence, sums of at most 48 products in another
order) and 1e-4 (gradients: three chained products). With an additive
mask, the plain versions and the mask's gradient are held to the Pallas
kernels in interpret mode at 1e-5 (test_torch_dropout.py and
test_torch_sdpa.py hold dropout and the entry points).
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
    """(The name predates the mask and dropout variants.) An additive mask
    runs the flash path's plain versions and matches the JAX reference;
    dropout no longer raises: it runs the plain versions with the Philox
    keep-mask that the CUDA kernels draw."""
    from paddle_tpu.ops.attention import _attention_reference as jax_ref
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                flash_attention,
                                                flash_fwd_plain)
    q, k, v, _ = _inputs(5, 1, 2, 16, 16, 16)
    mask = np.zeros((1, 1, 16, 16), np.float32)
    mask[..., :3] = -1e9
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             False, 0.25, mask=jnp.asarray(mask)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_attention(*t, causal=False, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    dropped = flash_attention(*t, dropout_p=0.1, dropout_seed=9)
    keep = dropout_keep_mask(9, 1, 2, 16, 16, 0.1)
    want, _ = flash_fwd_plain(*t, True, 0.25, keep=keep, dropout_p=0.1)
    assert torch.equal(dropped, want)
    assert torch.isfinite(dropped).all() and not keep.all()


# ---- the additive mask: the port's plain versions against the JAX Pallas
# kernels in interpret mode (`_flash_attention` with the mask operand),
# out, dq, dk, dv and dmask (jax.grad through its custom_vjp, whose mask
# cotangent is `_mask_grad`) at atol = rtol = 1e-5
MASK_CASES = [  # mask shape, causal, Sq, Sk, values
    ("b1", False, 32, 32, "normal"),
    ("b1", True, 32, 32, "big"),
    ("bh", True, 32, 64, "normal"),       # Sq < Sk
    ("bh", False, 64, 32, "-inf"),
    ("11", True, 64, 32, "normal"),       # Sq > Sk: rows with no key
    ("11", False, 32, 48, "big"),
    ("3d", False, 32, 32, "normal"),
    ("3d", True, 48, 48, "-inf"),
    ("b1", False, 32, 32, "row"),         # a row masked whole
    ("bh", True, 32, 32, "finfo"),
]


def _mask(kind, values, B, H, Sq, Sk, seed):
    shape = {"b1": (B, 1, Sq, Sk), "bh": (B, H, Sq, Sk),
             "11": (1, 1, Sq, Sk), "3d": (B, Sq, Sk)}[kind]
    rng = np.random.RandomState(seed)
    if values == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    hidden = rng.rand(*shape) < 0.3
    fill = {"big": -1e9, "-inf": -np.inf, "row": -np.inf,
            "finfo": np.finfo(np.float32).min}[values]
    m = np.where(hidden, fill, 0.0).astype(np.float32)
    if values == "row":
        m[..., 5, :] = -np.inf
    return m


@pytest.mark.parametrize("kind,causal,Sq,Sk,values", MASK_CASES)
def test_mask_matches_pallas_kernels_in_interpret_mode(kind, causal, Sq, Sk,
                                                       values):
    from paddle_tpu.ops.attention import _flash_attention
    from paddle_tpu_torch.ops.attention import flash_attention
    B, H, D, scale = 2, 2, 16, 0.25
    q, k, v, g = _inputs(6, B, H, Sq, Sk, D)
    mask = _mask(kind, values, B, H, Sq, Sk, 7)

    def fn(q_, k_, v_, m_):
        return _flash_attention(q_, k_, v_, m_, jnp.int32(0), causal, scale,
                                64, 64, 0.0)

    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    ref_out = np.asarray(fn(*jargs))
    ref_grads = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(g)),
                         argnums=(0, 1, 2, 3))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, mask)]
    out = flash_attention(*leaves[:3], causal=causal, scale=scale,
                          mask=leaves[3])
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=1e-5,
                               rtol=1e-5)
    for t, want in zip(leaves, ref_grads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    if values == "row":             # a row masked whole: 0 out, 0 grads
        assert not out.detach()[..., 5, :].any()
        assert not leaves[0].grad[..., 5, :].any()


@pytest.mark.parametrize("causal", [False, True])
def test_mask_plain_forward_lse_matches_the_pallas_forward(causal):
    from paddle_tpu.ops.attention import _flash_fwd
    from paddle_tpu_torch.ops.attention import flash_fwd_plain
    q, k, v, _ = _inputs(8, 2, 2, 32, 48, 16)
    mask = _mask("b1", "-inf", 2, 2, 32, 48, 9)
    jout, jlse = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v, mask)),
                            causal, 0.25, 64, 64, 0.0, 0)
    out, lse = flash_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal, 0.25, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)


def test_bf16_mask_plain_version_tracks_the_pallas_kernel():
    """bf16 q, k, v and a bf16 mask (summed in fp32 on both sides): two
    bf16 ulps of the output's scale, as without a mask."""
    from paddle_tpu.ops.attention import _flash_attention
    from paddle_tpu_torch.ops.attention import flash_attention
    q, k, v, _ = _inputs(10, 1, 2, 64, 64, 32)
    mask = _mask("b1", "normal", 1, 2, 64, 64, 11)
    jq, jk, jv, jm = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, mask))
    ref = np.asarray(_flash_attention(jq, jk, jv, jm, jnp.int32(0), True,
                                      1.0 / np.sqrt(32), 64, 64, 0.0)
                     .astype(jnp.float32))
    tq, tk, tv, tm = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                      .to(torch.bfloat16) for a in (jq, jk, jv, jm))
    out = flash_attention(tq, tk, tv, causal=True, mask=tm)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0 ** -6,
                               rtol=0)


def test_causal_mask_matches_jax():
    from paddle_tpu.ops.attention import causal_mask as jax_mask
    from paddle_tpu_torch.ops.attention import causal_mask
    for rows, cols, qo, ko in ((4, 6, 2, 0), (5, 3, 0, 1), (3, 3, 0, 0)):
        np.testing.assert_array_equal(
            causal_mask(rows, cols, qo, ko).numpy(),
            np.asarray(jax_mask(rows, cols, qo, ko)))


def test_fp16_mask_plain_version_tracks_the_pallas_kernel():
    """fp16 q, k, v and an fp16 mask (pure-fp16 training, whose masked
    and dropout variants have fp16 CUDA instantiations): the Pallas
    kernels in interpret mode against the port's plain version, out and
    the gradients of q, k and v. Both sides round p to fp16 before PV and
    each output once from fp32 sums in another order: atol 2^-9 for out
    and 2^-8 for the gradients, one fp16 ulp at their largest values here
    (|out| < 4, |grad| < 8) and two below half of that."""
    import jax
    from paddle_tpu.ops.attention import _flash_attention
    from paddle_tpu_torch.ops.attention import flash_attention
    q, k, v, g = _inputs(12, 1, 2, 64, 64, 32)
    mask = _mask("b1", "normal", 1, 2, 64, 64, 13)
    jq, jk, jv, jm, jg = (jnp.asarray(a, jnp.float16)
                          for a in (q, k, v, mask, g))

    def fn(q_, k_, v_):
        return _flash_attention(q_, k_, v_, jm, jnp.int32(0), True,
                                1.0 / np.sqrt(32), 64, 64, 0.0)

    out_ref, vjp = jax.vjp(fn, jq, jk, jv)
    want = [out_ref] + list(vjp(jg))
    leaves = [torch.from_numpy(np.array(a.astype(jnp.float32)))
              .to(torch.float16).requires_grad_() for a in (jq, jk, jv)]
    tm, tg = (torch.from_numpy(np.array(a.astype(jnp.float32)))
              .to(torch.float16) for a in (jm, jg))
    out = flash_attention(*leaves, causal=True, mask=tm)
    out.backward(tg)
    assert out.dtype == torch.float16
    for got, ref, atol in zip([out.detach()] + [t.grad for t in leaves],
                              want, (2.0 ** -9,) + (2.0 ** -8,) * 3):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=atol, rtol=0)


def test_fp16_dropout_plain_version_tracks_the_jax_reference():
    """fp16 dropout, fed JAX's own keep-mask (bernoulli(PRNGKey(s), 1 - p),
    as tests/test_torch_dropout.py feeds it in fp32): the port's plain
    forward and backward against the JAX reference and its jax.grad in
    fp16. Both round the dropped, rescaled p to fp16 before PV and each
    output once: atol 2^-9 for out and 2^-8 for the gradients, one fp16
    ulp at their largest values here (|out| < 4, |grad| < 8)."""
    import jax
    from paddle_tpu.ops.attention import _attention_reference as jax_ref
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_plain,
                                                flash_fwd_plain)
    q, k, v, g = _inputs(14, 2, 2, 24, 24, 16)
    p, scale = 0.25, 0.25
    key = jax.random.PRNGKey(11)
    keep = torch.from_numpy(np.asarray(
        jax.random.bernoulli(key, 1.0 - p, (2, 2, 24, 24))))
    jq, jk, jv, jg = (jnp.asarray(a, jnp.float16) for a in (q, k, v, g))
    out_ref, vjp = jax.vjp(lambda q_, k_, v_: jax_ref(
        q_, k_, v_, True, scale, dropout_p=p, dropout_key=key), jq, jk, jv)
    want = [out_ref] + list(vjp(jg))
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(torch.float16) for a in (jq, jk, jv, jg))
    out, lse = flash_fwd_plain(tq, tk, tv, True, scale, keep=keep,
                               dropout_p=p)
    grads = flash_bwd_plain(tq, tk, tv, tg, lse,
                            flash_attention_delta(tg, out), True, scale,
                            keep=keep, dropout_p=p)
    for got, ref, atol in zip((out,) + tuple(grads), want,
                              (2.0 ** -9,) + (2.0 ** -8,) * 3):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=atol, rtol=0)
