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
