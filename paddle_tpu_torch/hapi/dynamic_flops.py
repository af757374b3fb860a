"""paddle.flops (counterpart of paddle_tpu/hapi/dynamic_flops.py): the
multiply-accumulates of one forward, counted by forward hooks on the leaf
layers, each by its class name with the JAX counter's rules (`_count`).

The forward runs in the model's current mode, without autograd: in
training mode it moves the BatchNorm running statistics as any training
forward does (from a zero input the means stay 0 and the variances go
from v to 0.9·v), as the JAX counter does.
"""
from __future__ import annotations

import math

import torch


def _numel(t):
    return math.prod(t.shape) if hasattr(t, "shape") else 0


def _count(layer, inputs, output):
    cls = type(layer).__name__
    x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
    out_n = _numel(output if not isinstance(output, (tuple, list))
                   else output[0])
    if cls in ("Linear",):
        return out_n * layer.weight.shape[0]
    if cls in ("Conv2D", "Conv1D", "Conv3D"):
        w = layer.weight  # [out_ch, in_ch/groups, *k]
        return out_n * math.prod(w.shape[2:]) * w.shape[1]
    if cls in ("Conv2DTranspose", "Conv1DTranspose", "Conv3DTranspose"):
        # [in_ch, out_ch/groups, *k]: each input element scatters into
        # kernel x out_ch/groups outputs
        w = layer.weight
        return _numel(x) * math.prod(w.shape[2:]) * w.shape[1]
    if cls in ("BatchNorm2D", "BatchNorm1D", "BatchNorm", "LayerNorm",
               "GroupNorm", "InstanceNorm2D", "SyncBatchNorm"):
        return 2 * out_n
    if cls in ("ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "Softmax",
               "LeakyReLU", "Hardswish", "Hardsigmoid", "SiLU"):
        return out_n
    if cls in ("AvgPool2D", "MaxPool2D", "AdaptiveAvgPool2D",
               "AdaptiveMaxPool2D", "AvgPool1D", "MaxPool1D"):
        return out_n
    return 0


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """MACs of one forward of `net`, an int. Give `input_size` (a shape:
    an fp32 zero input on the device of net's first parameter) or
    `inputs` (tensors). custom_ops: {layer class: fn(layer, inputs,
    output) -> count}."""
    counts = []

    def hook(layer, args, output):
        fn = custom_ops.get(type(layer)) if custom_ops else None
        n = fn(layer, args, output) if fn else _count(layer, args, output)
        counts.append((type(layer).__name__, int(n)))

    handles = [sub.register_forward_hook(hook) for sub in net.modules()
               if not list(sub.children())]
    try:
        if inputs is None:
            if input_size is None:
                raise ValueError("flops() needs input_size or inputs")
            first = next(net.parameters(), None)
            device = first.device if first is not None else "cpu"
            inputs = [torch.zeros(tuple(input_size), dtype=torch.float32,
                                  device=device)]
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
    total = sum(n for _, n in counts)
    if print_detail:
        for name, n in counts:
            print(f"  {name}: {n:,}")
        print(f"Total Flops: {total:,}")
    return total
