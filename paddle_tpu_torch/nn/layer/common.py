"""Common layers (counterpart of paddle_tpu/nn/layer/common.py).

`Linear` keeps Paddle's `[in_features, out_features]` weight and computes
`y = x @ W + b` (`nn.functional.linear`, an autocast op), so the JAX
package's arrays load without a transpose. `weight_attr` / `bias_attr`
take a `ParamAttr` (False: no bias).
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .layers import Layer, create_parameter


def _xavier_uniform_(w: torch.Tensor, generator):
    fan_in, fan_out = w.shape[0], w.shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-limit, limit, generator=generator)


def xavier_normal_(w: torch.Tensor, generator):
    fan_in, fan_out = w.shape[0], w.shape[1]
    return w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                     generator=generator)


class Linear(Layer):
    """y = x @ W + b, W: [in_features, out_features]."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None, weight_attr=None, bias_attr=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = create_parameter([in_features, out_features], device,
                                       dtype, weight_attr)
        self.bias = (create_parameter([out_features], device, dtype,
                                      bias_attr) if bias else None)

    def reset_parameters(self, generator=None):
        _xavier_uniform_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, weight_attr=None):
        super().__init__()
        self.weight = create_parameter([num_embeddings, embedding_dim],
                                       device, dtype, weight_attr)

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class Dropout(Layer):
    """F.dropout in training, the identity (or the downscale) in eval."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Flatten(Layer):
    """`tensor.manipulation.flatten(x, start_axis, stop_axis)`."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...tensor.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)
