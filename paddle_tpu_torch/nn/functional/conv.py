"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py:1-100).

The JAX package computes them with `lax.conv_general_dilated`, outside any
Pallas kernel, so here they are `F.conv1d/2d/3d` (cuDNN on the card), as
a plain product is `torch.matmul`. Paddle's argument forms are kept:
`padding` is an int, one int a spatial dim, a (low, high) pair a dim
(flat `[l0, h0, l1, h1, ...]` or nested), `"SAME"` or `"VALID"`;
`stride` and `dilation` an int or one a dim; `groups`; an optional bias;
`data_format` channel-first (NCL/NCHW/NCDHW) or channel-last
(NLC/NHWC/NDHWC). The weight is `[out, in/groups, *k]` in both formats.
Each conv is one of the autocast op boundaries (`core/amp.py`), as
`autocast_inputs(f"conv{n}d", ...)` is in the JAX function.

Asymmetric padding (from a pair or from "SAME" with an even total) is
applied with `F.pad` before a conv that pads nothing; symmetric padding
goes to the conv itself.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...core.amp import autocast_inputs

_CHANNEL_LAST = ("NLC", "NHC", "NHWC", "NDHWC")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _padding(padding, n):
    """Paddle's padding forms -> "SAME", "VALID" or n (low, high) pairs,
    as the JAX package's `_padding` reads them."""
    if isinstance(padding, str):
        pad = padding.upper()
        if pad not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        return pad
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    pairs = [tuple(int(q) for q in p) for p in padding]
    if len(pairs) != n or any(len(p) != 2 for p in pairs):
        raise ValueError(f"padding {padding!r} does not give one (low, high) "
                         f"pair to each of {n} spatial dims")
    return pairs


def same_pads(spatial, window, strides):
    """The (low, high) pads of "SAME" over `spatial` with a `window` (the
    dilated kernel extent) and `strides`: out = ceil(in / s), the total
    split low-first as lax.padtype_to_pads splits it."""
    pads = []
    for size, k, s in zip(spatial, window, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def resolve_pads(pad, spatial, window, strides):
    """_padding's result -> explicit (low, high) pairs for `spatial`."""
    if pad == "VALID":
        return [(0, 0)] * len(spatial)
    if pad == "SAME":
        return same_pads(spatial, window, strides)
    return list(pad)


def pad_spatial(a, pairs, value=0.0):
    """`a` [N, C, *spatial] padded by (low, high) pairs, first dim first
    (F.pad takes the last dim's pair first)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return F.pad(a, flat, value=value)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    channel_last = data_format in _CHANNEL_LAST
    strides = _norm_tuple(stride, n)
    dil = _norm_tuple(dilation, n)
    ops = (x, weight) if bias is None else (x, weight, bias)
    x, weight, *maybe_bias = autocast_inputs(f"conv{n}d", *ops)
    bias = maybe_bias[0] if maybe_bias else None
    a = x.movedim(-1, 1) if channel_last else x
    window = [d * (k - 1) + 1 for d, k in zip(dil, weight.shape[2:])]
    pairs = resolve_pads(_padding(padding, n), a.shape[2:], window, strides)
    if all(lo == hi for lo, hi in pairs):
        conv_pad = tuple(lo for lo, _ in pairs)
    else:
        a = pad_spatial(a, pairs)
        conv_pad = 0
    out = _CONV[n](a, weight, bias, strides, conv_pad, dil, groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)

