"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

The parameter-free ones (activation.py:18-33) are one torch call each,
in the JAX function's formula (`hardsigmoid` keeps Paddle's slope
0.1666667 and offset 0.5, not torch's 1/6). softmax and log_softmax
(:116-137) are black-listed autocast ops (`core/amp.py`): under
`auto_cast` their bf16/fp16 input is taken to fp32 first, as in the JAX
package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.amp import autocast_inputs
from ...core.dtype import convert_dtype



def _unary(fn):
    def op(x, name=None):
        return fn(x)
    op.__name__ = fn.__name__
    return op


relu = _unary(torch.relu)
relu6 = _unary(F.relu6)
sigmoid = _unary(torch.sigmoid)
tanh = _unary(torch.tanh)
silu = _unary(F.silu)
swish = silu
mish = _unary(F.mish)
hardswish = _unary(F.hardswish)
tanhshrink = _unary(F.tanhshrink)
softsign = _unary(F.softsign)
log_sigmoid = _unary(F.logsigmoid)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """clip(slope * x + offset, 0, 1)."""
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    (x,) = autocast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    (x,) = autocast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=axis)
