"""Layer base (counterpart of paddle_tpu/nn/layer/layers.py).

Only what the models need: `Layer` is a `torch.nn.Module` with Paddle's
`set_state_dict` (aliases `set_dict`, `load_dict`), `LayerList` a
`torch.nn.ModuleList` and `Sequential` a `torch.nn.Sequential` that also
takes Paddle's `(name, layer)` tuples, so `named_parameters()` and
`named_buffers()` yield the same dotted names, in the same order, as the
JAX package's `functional_state()` keys (e.g.
`gpt.layers.0.self_attn.qkv_proj.weight`, `layer1.0.downsample.1._mean`). Parameters are created
empty on the caller's device and filled by `reset_parameters(generator)`
from an explicit `torch.Generator`.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def paddle_state_dict(module: torch.nn.Module) -> "OrderedDict":
    """The JAX `Layer.state_dict()` of `module`: every parameter
    (`named_parameters()` order), then every persistent buffer, sublayer
    by sublayer (layers.py:206-217). The values are the live tensors."""
    out = OrderedDict(module.named_parameters())
    for prefix, sub in module.named_modules():
        for name, b in sub._buffers.items():
            if b is None or name in sub._non_persistent_buffers_set:
                continue
            out[f"{prefix}.{name}" if prefix else name] = b
    return out


@torch.no_grad()
def set_state_dict(module: torch.nn.Module, state_dict):
    """Copy each entry of `state_dict` whose key names a parameter or
    buffer of `module` into it, cast to that tensor's dtype and moved to
    its device; skip the other keys. Returns (missing, unexpected): the
    module's keys the dict lacks, the dict's keys the module lacks, in
    the JAX `set_state_dict`'s order (layers.py:220-232). A value of
    another shape raises ValueError, as the JAX `set_value` does."""
    own = paddle_state_dict(module)
    missing, unexpected = [], []
    for k, v in state_dict.items():
        if k not in own:
            unexpected.append(k)
            continue
        t = own[k]
        src = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"set_state_dict: {k} has shape "
                             f"{tuple(src.shape)}, the layer's is "
                             f"{tuple(t.shape)}")
        t.copy_(src.to(device=t.device, dtype=t.dtype))
    for k in own:
        if k not in state_dict:
            missing.append(k)
    return missing, unexpected


class Layer(torch.nn.Module):
    """`torch.nn.Module` with Paddle's state-dict loading."""

    def set_state_dict(self, state_dict, use_structured_name=True):
        return set_state_dict(self, state_dict)

    set_dict = set_state_dict
    load_dict = set_state_dict


class LayerList(torch.nn.ModuleList, Layer):
    pass


class Sequential(torch.nn.Sequential, Layer):
    """Sublayers run in order, named "0", "1", ... or by `(name, layer)`
    tuples (given one by one or as one list), as in the JAX package
    (layers.py:400-420)."""

    def __init__(self, *layers):
        torch.nn.Module.__init__(self)
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            name, layer = layer if isinstance(layer, tuple) else (str(i),
                                                                  layer)
            self.add_module(name, layer)


class ParamAttr:
    """paddle.ParamAttr (counterpart of paddle_tpu/nn/layer/layers.py:23-40):
    what a layer's `weight_attr` / `bias_attr` says of one parameter. The
    parameter it makes carries `need_clip` (read by
    `ClipGradByGlobalNorm`), `optimize_attr = {"learning_rate": lr}` and
    `regularizer` as attributes, and `trainable=False` makes it a parameter
    without a gradient (the train steps leave it out). `name` is kept on
    the attr, and on the parameter as `attr_name`, which keys its
    optimizer slots in `Optimizer.state_dict()` as the JAX `p.name`
    does; the port names parameters by their module path.
    `initializer` must be None: the port's layers draw their weights from
    an explicit generator (`init_parameters`)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        if initializer is not None:
            raise NotImplementedError(
                "ParamAttr(initializer=...): the port's layers draw their "
                "weights in reset_parameters from an explicit generator")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None or True -> the default attr, False -> None (no parameter),
        a name -> ParamAttr(name=...), a ParamAttr as it is."""
        if attr is None or attr is True:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


def create_parameter(shape, device=None, dtype=None, attr=None):
    """An uninitialised parameter (its layer's reset_parameters fills it)
    with `attr`'s attributes, or None where `attr` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is None:
        return None
    p = torch.nn.Parameter(torch.empty(*shape, device=device,
                                       dtype=dtype or torch.float32),
                           requires_grad=attr.trainable)
    p.need_clip = attr.need_clip
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.attr_name = attr.name
    return p


def init_parameters(root: torch.nn.Module, generator: torch.Generator):
    """Fill every parameter of `root` by calling each sublayer's
    `reset_parameters(generator)` in module order, so one seed gives one
    set of weights on any device."""
    with torch.no_grad():
        for m in root.modules():
            fn = getattr(m, "reset_parameters", None)
            if fn is not None:
                fn(generator)
