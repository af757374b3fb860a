"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py:15-47).

layer_norm keeps fp32 statistics and casts back to the input dtype, and
is differentiable. On CUDA, a last-axis norm with weight and bias goes to
the hand-written LayerNorm kernels (ops/layernorm.py: the forward kernel,
and the backward kernel for its gradient); every other case, and every
CPU tensor, takes the plain math in the JAX package's op order, with
autograd through it.
"""
from __future__ import annotations

import torch


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape)
    if (n_axes == 1 and weight is not None and bias is not None
            and x.ndim >= 2):
        from ...ops.layernorm import fused_layer_norm
        return fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.ndim - n_axes, x.ndim))
    h = x.float()
    mu = h.mean(dim=axes, keepdim=True)
    var = (h - mu).square().mean(dim=axes, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
