"""LayerNorm layer (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer, create_parameter


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, device=None,
                 dtype=None, weight_attr=None, bias_attr=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = create_parameter(self._normalized_shape, device, dtype,
                                       weight_attr)
        self.bias = create_parameter(self._normalized_shape, device, dtype,
                                     bias_attr)

    def reset_parameters(self, generator=None):
        if self.weight is not None:
            self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)
