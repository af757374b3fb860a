"""matmul (counterpart of paddle_tpu/tensor/linalg.py:17-37).

A white-listed autocast op (`core/amp.py`): under `auto_cast` its fp32
operands run in the autocast dtype, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core.amp import autocast_inputs


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = autocast_inputs("matmul", x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)
