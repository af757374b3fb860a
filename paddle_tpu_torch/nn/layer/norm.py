"""LayerNorm and the BatchNorm family (counterpart of
paddle_tpu/nn/layer/norm.py:9-125).

The BatchNorms keep the JAX names: `weight` (ones) and `bias` (zeros),
each absent with `*_attr=False`, and the buffers `_mean` (zeros) and
`_variance` (ones), which `forward` moves in place in training through
`F.batch_norm` (momentum 0.9 is the old value's weight). Buffers are
made on the layer's device in its dtype and follow `.to()`.
`SyncBatchNorm` is BatchNorm at one process, as in the JAX package; its
`convert_sync_batchnorm` swaps every BatchNorm below a layer for one
holding the same tensors.
"""
from __future__ import annotations

import torch

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


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = create_parameter([num_features], device, dtype,
                                       weight_attr)
        self.bias = create_parameter([num_features], device, dtype,
                                     bias_attr)
        dtype = dtype or torch.float32
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device,
                                                  dtype=dtype))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device,
                                                     dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if self.weight is not None:
            self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm: BatchNorm2D with an optional `act` (the name
    of an `nn.functional` activation) applied to its output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 data_layout="NCHW", device=None, dtype=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon,
                         data_format=data_layout, device=device,
                         dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm; at one process it is BatchNorm."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name, device, dtype)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every BatchNorm below it (itself included) replaced
        by a SyncBatchNorm holding the same weight, bias and buffers (the
        same tensors, so an optimizer built over the old parameters still
        updates the new layer). Returns the new layer or `layer`."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False, bias_attr=False,
                      data_format=layer._data_format,
                      device=layer._mean.device, dtype=layer._mean.dtype)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer.named_children()):
            layer.add_module(name, cls.convert_sync_batchnorm(sub))
        return layer
