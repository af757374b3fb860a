"""Parameter-free activation layers (counterpart of
paddle_tpu/nn/layer/activation.py:9-32): each holds the keyword arguments
it was given and calls its `nn.functional` function with them. The
layers that hold parameters or options (PReLU, Maxout, RReLU, GELU, ...)
wait (ROADMAP §1 item 9)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


def _make(name, fn_name, **fixed):
    def __init__(self, name=None, **kwargs):
        Layer.__init__(self)
        self._kwargs = {**fixed, **kwargs}

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _make("ReLU", "relu")
ReLU6 = _make("ReLU6", "relu6")
Sigmoid = _make("Sigmoid", "sigmoid")
Tanh = _make("Tanh", "tanh")
Tanhshrink = _make("Tanhshrink", "tanhshrink")
Silu = _make("Silu", "silu")
Swish = _make("Swish", "swish")
Mish = _make("Mish", "mish")
Hardswish = _make("Hardswish", "hardswish")
Hardsigmoid = _make("Hardsigmoid", "hardsigmoid")
Softsign = _make("Softsign", "softsign")
LogSigmoid = _make("LogSigmoid", "log_sigmoid")
