"""The port's unfused cross-entropy against the JAX package:
`nn.functional.cross_entropy`, `softmax_with_cross_entropy` and
`ParallelCrossEntropy` (the Llama loss), forward and the logits'
gradient.

Inputs are drawn with numpy from a seed; labels hold ignore_index (-100)
tokens. fp32: losses and gradients within atol = rtol = 1e-5 (a
log-softmax over at most 37 classes in another order). bf16 logits: both
sides widen the same bf16 values to fp32 before the log-softmax, so the
fp32 losses stay within 1e-5; the gradient comes back in bf16 on both
sides, each element the rounding of an fp32 value that differs by ~1e-7
between the two, so it may land one bf16 ulp away: every element within
one ulp of the larger magnitude (+1e-7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import ulp_bf16

TOL = 1e-5


def _data(seed, shape=(3, 7), C=37, ignore=((0, 2), (2, 6))):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape + (C,)) * 2).astype(np.float32)
    y = rng.randint(0, C, shape).astype(np.int64)
    for i in ignore:
        y[i] = -100
    cot = rng.standard_normal(shape).astype(np.float32)
    return x, y, cot


def _jax(fn, x, *args, cot=None, dtype=jnp.float32, **kw):
    """(loss, d loss . cot / d x) of the JAX functional `fn` on logits x
    cast to `dtype`."""
    from paddle_tpu.core.tensor import Tensor

    def f(a):
        return fn(Tensor(a), *(Tensor(jnp.asarray(b)) for b in args),
                  **kw).data

    xa = jnp.asarray(x).astype(dtype)
    out = f(xa)
    c = jnp.ones_like(out) if cot is None else jnp.asarray(cot).reshape(
        out.shape)
    grad = jax.grad(lambda a: jnp.sum(f(a) * c))(xa)
    return (np.asarray(out, np.float32),
            np.asarray(grad.astype(jnp.float32)))


def _port(fn, x, *args, cot=None, dtype=torch.float32, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    out = fn(xt, *(torch.from_numpy(np.asarray(b)) for b in args), **kw)
    c = torch.ones_like(out) if cot is None else torch.from_numpy(
        cot).reshape(out.shape)
    (out * c).sum().backward()
    assert out.dtype == torch.float32 and xt.grad.dtype == dtype
    return out.detach().numpy(), xt.grad.float().numpy()


def _close(got, want, bf16=False):
    (lg, gg), (lw, gw) = got, want
    assert lg.shape == lw.shape
    np.testing.assert_allclose(lg, lw, atol=TOL, rtol=TOL)
    if bf16:
        ulp = ulp_bf16(np.maximum(np.abs(gg), np.abs(gw)))
        assert (np.abs(gg - gw) <= ulp + 1e-7).all()
    else:
        np.testing.assert_allclose(gg, gw, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction, dtype):
    from paddle_tpu.nn.functional.loss import cross_entropy as jce
    from paddle_tpu_torch.nn.functional import cross_entropy
    x, y, cot = _data(0)
    c = cot if reduction == "none" else None
    want = _jax(jce, x, y, cot=c, dtype=getattr(jnp, dtype),
                reduction=reduction)
    got = _port(cross_entropy, x, y, cot=c, dtype=getattr(torch, dtype),
                reduction=reduction)
    _close(got, want, bf16=dtype == "bfloat16")
    if reduction == "none":       # ignored targets: 0, and no gradient
        assert got[0][0, 2] == 0 and got[0][2, 6] == 0
        assert not got[1][0, 2].any()


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_cross_entropy_all_ignored(reduction):
    """Every target ignored: the mean divides by max(0, 1) and is 0; no
    gradient reaches the logits."""
    from paddle_tpu.nn.functional.loss import cross_entropy as jce
    from paddle_tpu_torch.nn.functional import cross_entropy
    x, _, _ = _data(1)
    y = np.full((3, 7), -100, np.int64)
    want = _jax(jce, x, y, reduction=reduction)
    got = _port(cross_entropy, x, y, reduction=reduction)
    _close(got, want)
    assert got[0] == 0 and not got[1].any()


@pytest.mark.parametrize("case", ["weight_mean", "weight_sum", "soft_label",
                                  "label_smoothing", "probabilities",
                                  "axis_1", "ignore_index_5"])
def test_cross_entropy_options_match_jax(case):
    from paddle_tpu.nn.functional.loss import cross_entropy as jce
    from paddle_tpu_torch.nn.functional import cross_entropy
    x, y, _ = _data(2)
    rng = np.random.RandomState(3)
    args, kw = (y,), {}
    if case.startswith("weight"):
        kw = dict(weight=rng.uniform(0.5, 2.0, 37).astype(np.float32),
                  reduction=case[7:])
    elif case == "soft_label":
        soft = rng.uniform(0, 1, x.shape).astype(np.float32)
        args, kw = (soft / soft.sum(-1, keepdims=True),), dict(
            soft_label=True)
    elif case == "label_smoothing":
        kw = dict(label_smoothing=0.1)
    elif case == "probabilities":
        e = np.exp(x - x.max(-1, keepdims=True))
        x = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        kw = dict(use_softmax=False)
    elif case == "axis_1":
        x = np.ascontiguousarray(np.moveaxis(x, -1, 1))     # [3, 37, 7]
        kw = dict(axis=1)
    else:
        y = np.where(y == -100, 5, y)
        args, kw = (y,), dict(ignore_index=5)
    jw = kw.pop("weight", None)
    jargs = args if jw is None else args + (jw,)
    want = _jax(lambda a, *b, **k: jce(a, b[0], *b[1:], **k), x, *jargs,
                **kw)
    if jw is not None:
        kw["weight"] = torch.from_numpy(jw)
    got = _port(cross_entropy, x, *args, **kw)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trailing_one", [False, True])
def test_softmax_with_cross_entropy_matches_jax(trailing_one, dtype):
    """Unreduced; a label with a trailing 1 gives a loss with one too."""
    from paddle_tpu.nn.functional.loss import \
        softmax_with_cross_entropy as jswce
    from paddle_tpu_torch.nn.functional import softmax_with_cross_entropy
    x, y, cot = _data(4)
    if trailing_one:
        y = y[..., None]
    want = _jax(jswce, x, y, cot=cot, dtype=getattr(jnp, dtype))
    got = _port(softmax_with_cross_entropy, x, y, cot=cot,
                dtype=getattr(torch, dtype))
    assert got[0].shape == ((3, 7, 1) if trailing_one else (3, 7))
    _close(got, want, bf16=dtype == "bfloat16")


def test_softmax_with_cross_entropy_returns_softmax():
    from paddle_tpu.nn.functional.loss import \
        softmax_with_cross_entropy as jswce
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu_torch.nn.functional import softmax_with_cross_entropy
    x, y, _ = _data(5)
    jl, jp = jswce(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y)),
                   return_softmax=True)
    tl, tp = softmax_with_cross_entropy(torch.from_numpy(x),
                                        torch.from_numpy(y),
                                        return_softmax=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.data), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp.data), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parallel_cross_entropy_matches_jax(dtype):
    """At degree 1, over [B, S, V] logits with [B, S] labels (the Llama
    loss's shapes)."""
    from paddle_tpu.distributed.meta_parallel.mp_layers import \
        ParallelCrossEntropy as JaxPCE
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    x, y, cot = _data(6, shape=(2, 9), ignore=((0, 0), (1, 8)))
    want = _jax(JaxPCE(), x, y, cot=cot, dtype=getattr(jnp, dtype))
    got = _port(ParallelCrossEntropy(), x, y, cot=cot,
                dtype=getattr(torch, dtype))
    assert got[0].shape == (2, 9)
    _close(got, want, bf16=dtype == "bfloat16")


def test_parallel_cross_entropy_honours_ignore_index():
    """The JAX layer's unsharded path drops its ignore_index; the port's
    keeps it: equal to softmax_with_cross_entropy(ignore_index=5)."""
    from paddle_tpu.nn.functional.loss import \
        softmax_with_cross_entropy as jswce
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    x, y, cot = _data(7)
    y = np.where(y == -100, 5, y)
    want = _jax(jswce, x, y, cot=cot, ignore_index=5)
    got = _port(ParallelCrossEntropy(ignore_index=5), x, y, cot=cot)
    _close(got, want)
    assert (got[0][y == 5] == 0).all()
