"""What the vision models share: the device and dtype keywords and the
seeded weight draw, as `resnet.py` takes them."""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from ...core.dtype import convert_dtype
from ...nn.layer.layers import init_parameters


def layer_kw(device, dtype):
    """{device, dtype} for a model's layers: `device` resolved (CUDA by
    default; raises without a GPU), `dtype` float32 by default."""
    return dict(device=resolve_device(device),
                dtype=convert_dtype(dtype) or torch.float32)


def draw_weights(model, device, generator=None):
    """Fill `model`'s parameters in module order from `generator` (a
    torch.Generator on `device`, seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    init_parameters(model, generator)
