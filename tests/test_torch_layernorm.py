"""LayerNorm in the PyTorch port against the JAX package.

The port's `layer_norm` (plain version on the CPU) is held to the JAX
`fused_layer_norm(force_pallas=True)` — the real Pallas forward kernel in
interpret mode — and to the JAX `nn.functional.layer_norm`: fp32 at
atol/rtol 1e-5, bf16 inputs within one bf16 ulp of the output. The
backward — dx, dw and db, by autograd through the port's `layer_norm` and
by its plain backward `layer_norm_bwd_plain` — is held to `jax.grad` of
the same Pallas call (its backward kernel in interpret mode): fp32 at
atol/rtol 1e-5 for dx and 1e-4 for dw and db (sums over the rows in
another order). (The CUDA kernels are held to the plain versions on the
card in test_torch_cuda_kernels.py.)
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import layernorm_inputs as _data
from _torch_port import ulp_bf16 as _ulp_bf16
from _torch_port import ulp_fp16


def test_fp32_matches_pallas_interpret_and_functional():
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.ops.layernorm import fused_layer_norm as jax_fused
    from paddle_tpu_torch.nn.functional import layer_norm
    x, w, b = _data(0, (2, 8, 256), 256)      # 16 rows: Pallas-tileable
    out = layer_norm(torch.from_numpy(x), 256, torch.from_numpy(w),
                     torch.from_numpy(b)).numpy()
    pallas = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 1e-5, force_pallas=True))
    func = np.asarray(JF.layer_norm(x, 256, w, b).data)
    np.testing.assert_allclose(out, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, func, atol=1e-5, rtol=1e-5)


def test_bf16_within_one_ulp_of_jax():
    from paddle_tpu.ops.layernorm import fused_layer_norm as jax_fused
    from paddle_tpu_torch.nn.functional import layer_norm
    x, w, b = _data(1, (16, 384), 384)
    xb, wb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    ref = np.asarray(jax_fused(xb, wb, bb, 1e-5,
                               force_pallas=True).astype(jnp.float32))
    tb = lambda a: torch.from_numpy(                   # noqa: E731
        np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    out = layer_norm(tb(xb), 384, tb(wb), tb(bb))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    big = np.maximum(np.abs(out), np.abs(ref))
    assert (np.abs(out - ref) <= _ulp_bf16(big)).all()


@pytest.mark.parametrize("shape,norm,affine", [
    ((3, 5, 12), [5, 12], True),      # two normalised axes: plain path
    ((4, 10), 10, False),             # no weight/bias: plain path
    ((7, 33), 33, True),              # odd width: kernel path (plain on CPU)
])
def test_other_shapes_match_jax_functional(shape, norm, affine):
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn.functional import layer_norm
    nshape = [norm] if isinstance(norm, int) else norm
    rng = np.random.RandomState(2)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(nshape).astype(np.float32) if affine else None
    b = rng.standard_normal(nshape).astype(np.float32) if affine else None
    ref = np.asarray(JF.layer_norm(x, norm, w, b).data)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = layer_norm(t(x), norm, t(w), t(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_layer_returns_stats_like_the_jax_kernel():
    """The plain forward also returns fp32 mean and rstd [R, 1], as the
    JAX kernel does (the backward reads them)."""
    from paddle_tpu.ops.layernorm import _fused_fwd
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd
    x, w, b = _data(3, (8, 128), 128)
    y, mu, rstd = layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), 1e-5)
    jy, jmu, jrstd = _fused_fwd(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), 1e-5)
    assert mu.shape == (8, 1) and rstd.dtype == torch.float32
    for a, r in ((y, jy), (mu, jmu), (rstd, jrstd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


def _jax_ln_grads(x, w, b, dy):
    import jax
    from paddle_tpu.ops.layernorm import fused_layer_norm as jax_fused

    def loss(x_, w_, b_):
        y = jax_fused(x_, w_, b_, 1e-5, force_pallas=True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))]


@pytest.mark.parametrize("shape,n", [((2, 8, 256), 256), ((32, 128), 128)])
def test_backward_matches_the_pallas_backward_kernel(shape, n):
    from paddle_tpu_torch.nn.functional import layer_norm
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_plain,
                                                layer_norm_fwd_plain)
    x, w, b = _data(7, shape, n)
    dy = np.random.RandomState(8).standard_normal(shape).astype(np.float32)
    want = _jax_ln_grads(x, w, b, dy)
    tols = (1e-5, 1e-4, 1e-4)
    # autograd through the port's layer_norm (the CPU path)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    layer_norm(xt, n, wt, bt).backward(torch.from_numpy(dy))
    for t, ref, tol in zip((xt, wt, bt), want, tols):
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=tol, rtol=tol)
    # the backward kernel's plain version, from the forward's statistics
    x2, dy2 = torch.from_numpy(x.reshape(-1, n)), \
        torch.from_numpy(dy.reshape(-1, n))
    _, mu, rstd = layer_norm_fwd_plain(x2, torch.from_numpy(w),
                                       torch.from_numpy(b), 1e-5)
    got = layer_norm_bwd_plain(x2, torch.from_numpy(w), mu, rstd, dy2)
    for g, ref, tol in zip(got, want, tols):
        np.testing.assert_allclose(g.numpy().reshape(ref.shape), ref,
                                   atol=tol, rtol=tol)


def test_backward_bf16_grads_in_parameter_dtype():
    """bf16 inputs: dx in x's dtype, dw/db summed in fp32 and cast to w's
    dtype, as the JAX vjp casts them; each within one bf16 ulp (+ 1e-5)
    of the JAX result (both round one fp32 value once)."""
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_plain,
                                                layer_norm_fwd_plain)
    x, w, b = _data(9, (16, 256), 256)
    dy = np.random.RandomState(10).standard_normal((16, 256)).astype(
        np.float32)
    xb, wb, bb, dyb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, dy))
    import jax
    from paddle_tpu.ops.layernorm import fused_layer_norm as jax_fused
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_fused(x_, w_, b_, 1e-5,
                                                  force_pallas=True),
                     xb, wb, bb)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(dyb)]
    tb = lambda a: torch.from_numpy(                   # noqa: E731
        np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    xt, wt, bt, dyt = tb(xb), tb(wb), tb(bb), tb(dyb)
    _, mu, rstd = layer_norm_fwd_plain(xt, wt, bt, 1e-5)
    got = layer_norm_bwd_plain(xt, wt, mu, rstd, dyt)
    for g, ref in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        big = np.maximum(np.abs(g), np.abs(ref))
        assert (np.abs(g - ref) <= _ulp_bf16(big) + 1e-5).all()


def _fp16(a):
    """A jnp fp16 array as a torch fp16 tensor (exact)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.float16)


def test_fp16_forward_and_backward_within_one_ulp_of_the_pallas_kernels():
    """fp16 inputs (pure-fp16 training, fp16 serving): the Pallas forward
    and backward kernels in interpret mode against the port's plain
    versions. Both compute in fp32 and round each output once, so every
    element is within one fp16 ulp of the larger magnitude, plus what the
    unrounded fp32 values may differ by where an output is near 0 (sums
    in another order: 1e-6 for y and dx, 1e-5 for dw and db, summed over
    the rows)."""
    import jax
    from paddle_tpu.ops.layernorm import fused_layer_norm as jax_fused
    from paddle_tpu_torch.nn.functional import layer_norm
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_plain,
                                                layer_norm_fwd_plain)
    x, w, b = _data(11, (16, 384), 384)
    dy = np.random.RandomState(12).standard_normal((16, 384)).astype(
        np.float32)
    xh, wh, bh, dyh = (jnp.asarray(a, jnp.float16) for a in (x, w, b, dy))
    y_ref, vjp = jax.vjp(lambda x_, w_, b_: jax_fused(
        x_, w_, b_, 1e-5, force_pallas=True), xh, wh, bh)
    assert y_ref.dtype == jnp.float16
    want = [np.asarray(y_ref.astype(jnp.float32))] + [
        np.asarray(g.astype(jnp.float32)) for g in vjp(dyh)]
    xt, wt, bt, dyt = (_fp16(a) for a in (xh, wh, bh, dyh))
    y = layer_norm(xt, 384, wt, bt)
    _, mu, rstd = layer_norm_fwd_plain(xt, wt, bt, 1e-5)
    got = (y,) + layer_norm_bwd_plain(xt, wt, mu, rstd, dyt)
    for g, ref, atol in zip(got, want, (1e-6, 1e-6, 1e-5, 1e-5)):
        assert g.dtype == torch.float16
        g = g.float().numpy()
        big = np.maximum(np.abs(g), np.abs(ref))
        assert (np.abs(g - ref) <= ulp_fp16(big) + atol).all()
