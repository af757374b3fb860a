"""softmax and log_softmax (counterpart of
paddle_tpu/nn/functional/activation.py:116-137).

Both are black-listed autocast ops (`core/amp.py`): under `auto_cast`
their bf16/fp16 input is taken to fp32 first, as in the JAX package.
"""
from __future__ import annotations

import torch

from ...core.amp import autocast_inputs
from ...core.dtype import convert_dtype


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
