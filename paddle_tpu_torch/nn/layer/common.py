"""Common layers (counterpart of paddle_tpu/nn/layer/common.py).

`Linear` keeps Paddle's `[in_features, out_features]` weight and computes
`y = x @ W + b`, so the JAX package's arrays load without a transpose.
"""
from __future__ import annotations

import math

import torch

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
                 dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = create_parameter([in_features, out_features], device,
                                       dtype)
        self.bias = (create_parameter([out_features], device, dtype)
                     if bias else None)

    def reset_parameters(self, generator=None):
        _xavier_uniform_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None):
        super().__init__()
        self.weight = create_parameter([num_embeddings, embedding_dim],
                                       device, dtype)

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class Dropout(Layer):
    """Identity in eval and at p = 0 (every GPT preset). Training-mode
    dropout with p > 0 is refused rather than given a different random
    stream from the JAX package's."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if self.training and self.p > 0:
            raise NotImplementedError(
                "training-mode dropout with p > 0 waits for the dropout "
                "slice (ROADMAP §1: mask and dropout variants)")
        return x
