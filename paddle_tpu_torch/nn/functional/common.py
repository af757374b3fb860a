"""`linear` and dropout (counterpart of paddle_tpu/nn/functional/common.py:17-61).

`linear` is one of the autocast op boundaries (`core/amp.py`): under
`auto_cast` its fp32 inputs run in the autocast dtype, as the JAX
function's `autocast_inputs("linear", ...)` casts them.

Not a Pallas kernel in the JAX package, so plain PyTorch here. The keep
draws come from the device's generator in `core.random` (the JAX package
draws `bernoulli(next_key(), 1 - p)`): the same rule, other bits.
"""
from __future__ import annotations

import torch

from ...core.amp import autocast_inputs
from ...core.random import generator


def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with Paddle's [in_features, out_features] weight."""
    if bias is None:
        x, weight = autocast_inputs("linear", x, weight)
        return x @ weight
    x, weight, bias = autocast_inputs("linear", x, weight, bias)
    return x @ weight + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (or each slice along the dims not in `axis`)
    with probability p. `upscale_in_train` scales the kept ones by
    1 / (1 - p) in training and leaves eval alone; `downscale_in_infer`
    keeps them as they are in training and scales eval by (1 - p). p = 1
    gives zeros."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    u = torch.rand(shape, generator=generator(x.device), device=x.device)
    keep = u < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)
