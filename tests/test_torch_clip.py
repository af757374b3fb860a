"""`need_clip` in the port's ClipGradByGlobalNorm against the JAX class
it ports (paddle_tpu.nn.ClipGradByGlobalNorm, the eager step's clip).

A parameter whose `need_clip` is False is left out of the global norm
and its gradient passes through untouched; a parameter without the
attribute counts as True; a None gradient passes through. Both classes
take the same (param, grad) pairs, the grads drawn with numpy from a
seed. Limits: fp32 atol = rtol = 1e-6 (the same fp32 ops; the JAX side
adds the squared norms left to right, the port with one tensor sum, so
the factor may round one ulp apart). bf16: within one bf16 ulp of the
JAX value, because both scale the fp32 value of the gradient by their
fp32 factor and round once, so a factor one fp32 ulp apart can move
only a value that lands near a rounding midpoint. Gradients that are
not clipped must come back bit for bit, as the same tensor.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

_ABSENT = object()


class _Param:
    """A parameter stand-in: a name and, unless absent, `need_clip`."""

    def __init__(self, name, need_clip=_ABSENT):
        self.name = name
        if need_clip is not _ABSENT:
            self.need_clip = need_clip


# (name, shape, need_clip or _ABSENT, has a grad)
CASES = {
    "mixed": [("a", (6, 5), True, True), ("b", (5,), False, True),
              ("c", (5, 3), _ABSENT, True), ("d", (3,), True, False),
              ("e", (4, 4), False, True)],
    "one_excluded": [("a", (6, 5), _ABSENT, True),
                     ("b", (7, 3), False, True)],
    "all_false": [("a", (6, 5), False, True), ("b", (5,), False, True),
                  ("c", (3,), False, False)],
    "only_none_left": [("a", (6, 5), False, True), ("b", (5,), True, False)],
}


def _run_both(case, dtype, seed=7, scale=3.0):
    from paddle_tpu import nn as jnn
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    rng = np.random.RandomState(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    params, grads = [], []
    for name, shape, need, has in CASES[case]:
        params.append(_Param(name, need))
        grads.append((rng.standard_normal(shape) * scale).astype(np.float32)
                     if has else None)
    jpairs = [(p, None if g is None else Tensor(jnp.asarray(g, jdt)))
              for p, g in zip(params, grads)]
    tpairs = [(p, None if g is None else torch.from_numpy(g).to(dtype))
              for p, g in zip(params, grads)]
    want = jnn.ClipGradByGlobalNorm(1.0)(jpairs)
    got = ClipGradByGlobalNorm(1.0)(tpairs)
    return tpairs, got, want


def _check(tpairs, got, want, dtype):
    from _torch_port import ulp_bf16
    assert len(got) == len(want) == len(tpairs)
    for (p_in, g_in), (p, g), (pj, gj) in zip(tpairs, got, want):
        assert p is p_in and pj is p_in
        if g_in is None:
            assert g is None and gj is None
            continue
        if not getattr(p, "need_clip", True):
            assert g is g_in          # passed through untouched
        assert g.dtype == dtype
        gv = g.float().numpy()
        wv = np.asarray(gj.data.astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(gv, wv, atol=1e-6, rtol=1e-6)
        else:
            big = np.maximum(np.abs(gv), np.abs(wv))
            assert (np.abs(gv - wv) <= ulp_bf16(big)).all(), \
                float(np.abs(gv - wv).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_global_norm_need_clip_matches_jax(case, dtype):
    _check(*_run_both(case, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_excluded_grad_does_not_enter_the_norm(dtype):
    """With `b` excluded the factor is the one of `a` alone: `a` comes out
    at norm 1 (it is clipped), `b` keeps its own, larger norm."""
    tpairs, got, _ = _run_both("one_excluded", dtype, scale=5.0)
    a = got[0][1].float()
    b_in = tpairs[1][1]
    np.testing.assert_allclose(float(a.norm()), 1.0, rtol=1e-2)
    assert got[1][1] is b_in and float(b_in.float().norm()) > 1.0
    # on the parent tree (no need_clip) both were scaled by one factor
    a_in = tpairs[0][1].float()
    both = float(torch.cat([a_in.flatten(), b_in.float().flatten()]).norm())
    assert abs(float(a.norm()) - float(a_in.norm()) / both) > 1e-2


def test_all_excluded_returns_the_input_unchanged():
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    tpairs, got, _ = _run_both("all_false", torch.float32)
    assert got == tpairs
    assert all(g is g_in for (_, g), (_, g_in) in zip(got, tpairs))
    assert ClipGradByGlobalNorm(1.0)([]) == []


def test_parameter_attribute_is_honoured():
    """`need_clip` set on a torch Parameter, as a model's parameters carry
    it: the excluded gradient comes back as the same tensor, the other is
    scaled by the factor of its own norm alone."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    p = torch.nn.Parameter(torch.zeros(4))
    q = torch.nn.Parameter(torch.zeros(4))
    q.need_clip = False
    gp, gq = torch.full((4,), 10.0), torch.full((4,), 10.0)
    (_, op), (_, oq) = ClipGradByGlobalNorm(1.0)([(p, gp), (q, gq)])
    assert oq is gq
    np.testing.assert_allclose(op.numpy(), 0.5, rtol=1e-6)


# ---- clip_grad_norm_ (paddle_tpu/nn/clip.py:79): the norm and the
# clipped gradients, in place, against the JAX function on the same
# gradients. fp32 atol = rtol = 1e-6 (the per-parameter sums are added in
# another order); bf16 gradients within one bf16 ulp (each is scaled in
# fp32 by a factor one fp32 ulp apart at most, and rounded once).
def _clip_norm_both(dtype, max_norm, norm_type, poison=None, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.nn.clip import clip_grad_norm_ as jax_clip
    from paddle_tpu_torch.nn.clip import clip_grad_norm_
    rng = np.random.RandomState(5)
    shapes = [(6, 5), (5,), (3, 3)]
    grads = [rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
    if poison is not None:
        grads[1][2] = poison
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jps, tps = [], []
    for g in grads:
        jp = paddle.create_parameter(list(g.shape), "float32")
        jp.grad = paddle.to_tensor(jnp.asarray(g, jdt))
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(g.shape, dtype=dtype))
        tp.grad = torch.from_numpy(g).to(dtype)
        tps.append(tp)
    tps.append(torch.nn.Parameter(torch.zeros(2)))     # no gradient
    jtotal = jax_clip(jps, max_norm, norm_type, **kw)
    ttotal = clip_grad_norm_(tps, max_norm, norm_type, **kw)
    return jps, tps, jtotal, ttotal


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm,norm_type", [(1.0, 2.0), (100.0, 2.0),
                                                (0.5, 1.0),
                                                (1.0, float("inf"))])
def test_clip_grad_norm_matches_jax(dtype, max_norm, norm_type):
    jps, tps, jtotal, ttotal = _clip_norm_both(dtype, max_norm, norm_type)
    assert ttotal.dtype == torch.float32 and ttotal.ndim == 0
    np.testing.assert_allclose(float(ttotal), float(np.asarray(jtotal.data)),
                               atol=1e-6, rtol=1e-6)
    for jp, tp in zip(jps, tps):
        assert tp.grad.dtype == dtype
        got = tp.grad.float().numpy()
        want = np.asarray(jp.grad.data, np.float32)
        if dtype == torch.bfloat16:
            from _torch_port import ulp_bf16
            assert (np.abs(got - want) <= ulp_bf16(want) + 1e-7).all()
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert tps[-1].grad is None


@pytest.mark.parametrize("poison", [np.inf, np.nan])
def test_clip_grad_norm_error_if_nonfinite(poison):
    with pytest.raises(RuntimeError, match="non-finite"):
        _clip_norm_both(torch.float32, 1.0, 2.0, poison,
                        error_if_nonfinite=True)
    # by default both scale by the non-finite norm alike
    jps, tps, jtotal, ttotal = _clip_norm_both(torch.float32, 1.0, 2.0,
                                               poison)
    assert not np.isfinite(float(ttotal))
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(np.isnan(tp.grad.numpy()),
                                      np.isnan(np.asarray(jp.grad.data)))


def test_clip_grad_norm_without_gradients_returns_zero():
    from paddle_tpu_torch.nn.clip import clip_grad_norm_
    assert float(clip_grad_norm_([torch.nn.Parameter(torch.ones(3))],
                                 1.0)) == 0.0


def test_param_attr_need_clip_is_honoured():
    """ParamAttr(need_clip=False) on a layer's weight keeps it out of the
    global norm and leaves its gradient untouched, as the JAX layer does
    with the same attr."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.layer.layers import ParamAttr
    jl = paddle.nn.Linear(4, 3, weight_attr=paddle.ParamAttr(
        need_clip=False))
    tl = Linear(4, 3, device="cpu", weight_attr=ParamAttr(need_clip=False),
                bias_attr=ParamAttr(learning_rate=0.5))
    assert tl.weight.need_clip is False and tl.bias.need_clip is True
    assert tl.bias.optimize_attr == {"learning_rate": 0.5}
    rng = np.random.RandomState(9)
    gw = rng.standard_normal((4, 3)).astype(np.float32) * 5
    gb = rng.standard_normal((3,)).astype(np.float32) * 5
    want = JaxClip(0.5)([(jl.weight, paddle.to_tensor(gw)),
                         (jl.bias, paddle.to_tensor(gb))])
    got = ClipGradByGlobalNorm(0.5)([(tl.weight, torch.from_numpy(gw)),
                                     (tl.bias, torch.from_numpy(gb))])
    np.testing.assert_array_equal(got[0][1].numpy(), gw)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.data), atol=1e-6,
                                   rtol=1e-6)


def test_param_attr_forms_and_trainable():
    from paddle_tpu_torch.nn import LayerNorm, Linear
    from paddle_tpu_torch.nn.layer.layers import ParamAttr
    lin = Linear(4, 3, device="cpu", weight_attr=ParamAttr(trainable=False),
                 bias_attr=False)
    assert lin.bias is None and not lin.weight.requires_grad
    ln = LayerNorm(4, device="cpu", weight_attr="w", bias_attr=False)
    assert ln.bias is None and ln.weight.need_clip
    x = torch.randn(2, 4)
    with torch.no_grad():
        ln.reset_parameters()
    torch.testing.assert_close(ln(x), torch.nn.functional.layer_norm(
        x, (4,), torch.ones(4), None, 1e-5), atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="initializer"):
        ParamAttr(initializer=object())
    with pytest.raises(TypeError):
        Linear(4, 3, device="cpu", weight_attr=3.0)
