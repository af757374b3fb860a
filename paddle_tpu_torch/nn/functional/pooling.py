"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

The JAX package pools with `lax.reduce_window`, outside any Pallas
kernel, so here the pools are torch's (cuDNN or ATen kernels on the card).
The JAX functions' rules are kept:

- `padding` takes the conv forms (`conv._padding`: ints, pairs, "SAME",
  "VALID"); a max pool's padding never wins (it is -inf), an average
  pool's counts as 0;
- `ceil_mode` emits the trailing partial window, but never one that
  starts past the input and its low pad (the pool_op clamp); it is
  refused with "VALID";
- an average divides by `divisor_override` if given, else with
  `exclusive` and any padding (the ceil extension included) by the count
  of input elements in the window, else by the kernel's size;
- the adaptive pools' bins run from floor(i·in/out) to ceil((i+1)·in/out)
  (`_adaptive_axes`), which are torch's bins;
- `return_mask` gives the flat index of each max within its (N, C)
  slice's input volume, int32, in NC* layout and floor mode only.

Symmetric padding of at most half the kernel goes to torch's pool itself,
whose output-size and ceil rules are the same; any other padding is
applied with `F.pad` first (-inf or 0), the windows summed with
`divisor_override=1` and divided as above. 1-D pools run as 2-D pools
over a [N, C, 1, L] view.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .conv import _norm_tuple, _padding, pad_spatial, resolve_pads

_CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")
_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _ceil_pads(spatial, ks, st, pairs):
    """`pairs` with each high pad extended so that the trailing partial
    window is emitted (pool_op's ceil formula with its clamp)."""
    out = []
    for size, k, s, (lo, hi) in zip(spatial, ks, st, pairs):
        if k == 1 and s == 1:
            out.append((lo, hi))
            continue
        span = size + lo + hi
        n_floor = (span - k) // s + 1
        n_ceil = -((span - k) // -s) + 1
        if (n_ceil - 1) * s >= size + lo:
            n_ceil -= 1
        if n_ceil > n_floor:
            hi += (n_ceil - 1) * s + k - span
        out.append((lo, hi))
    return out


def _lift(a, ks, st, pairs):
    """A 1-D pool's operands as a 2-D pool's over [N, C, 1, L]."""
    return (a.unsqueeze(2), (1,) + ks, (1,) + st, [(0, 0)] + pairs)


def _plan(a, kernel, stride, padding, n, ceil_mode):
    """(kernel, stride, explicit (low, high) pairs or None for torch's own
    symmetric padding, that padding) of a pool over a's spatial dims."""
    ks = _norm_tuple(kernel, n)
    st = _norm_tuple(stride if stride is not None else kernel, n)
    pad = _padding(padding, n)
    if ceil_mode and pad == "VALID":
        raise ValueError('When padding is "VALID", ceil_mode must be False '
                         "(reference pooling contract)")
    pairs = resolve_pads(pad, a.shape[2:], ks, st)
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pairs, ks))
    return ks, st, pairs, native


def _max_pool(x, kernel, stride, padding, n, data_format, ceil_mode,
              return_mask):
    channel_last = data_format in _CHANNEL_LAST
    if return_mask and (ceil_mode or channel_last):
        raise NotImplementedError(
            "return_mask supports NC* floor-mode only (pool_with_index_op.cc "
            "parity)")
    a = x.movedim(-1, 1) if channel_last else x
    ks, st, pairs, native = _plan(a, kernel, stride, padding, n, ceil_mode)
    spatial = a.shape[2:]
    if n == 1:
        a, ks, st, pairs = _lift(a, ks, st, pairs)
    if native:
        res = _MAX[len(ks)](a, ks, st, [lo for lo, _ in pairs],
                            ceil_mode=ceil_mode, return_indices=return_mask)
    else:
        if ceil_mode:
            pairs = _ceil_pads(a.shape[2:], ks, st, pairs)
        res = _MAX[len(ks)](pad_spatial(a, pairs, -math.inf), ks, st,
                            return_indices=return_mask)
    out, idx = res if return_mask else (res, None)
    if n == 1:
        out = out.squeeze(2)
        idx = None if idx is None else idx.squeeze(2)
    if channel_last:
        out = out.movedim(1, -1)
    if not return_mask:
        return out
    if not native:
        idx = _unpadded_index(idx, [p for p in pairs[-n:]], spatial)
    return out, idx.int()


def _unpadded_index(idx, pairs, spatial):
    """Flat indices into the padded spatial volume -> into the input's."""
    padded = [s + lo + hi for s, (lo, hi) in zip(spatial, pairs)]
    flat = torch.zeros_like(idx)
    rem = idx
    coords = []
    for size in reversed(padded):
        coords.append(rem % size)
        rem = rem // size
    for c, (lo, _), size in zip(reversed(coords), pairs, spatial):
        flat = flat * size + (c - lo)
    return flat


def _avg_pool(x, kernel, stride, padding, n, data_format, ceil_mode,
              exclusive, divisor_override):
    channel_last = data_format in _CHANNEL_LAST
    a = x.movedim(-1, 1) if channel_last else x
    ks, st, pairs, native = _plan(a, kernel, stride, padding, n, ceil_mode)
    if n == 1:
        a, ks, st, pairs = _lift(a, ks, st, pairs)
    if native and not ceil_mode:
        out = _AVG[len(ks)](a, ks, st, [lo for lo, _ in pairs],
                            count_include_pad=not exclusive,
                            divisor_override=divisor_override)
    else:
        if ceil_mode:
            pairs = _ceil_pads(a.shape[2:], ks, st, pairs)
        pool = _AVG[len(ks)]
        out = pool(pad_spatial(a, pairs), ks, st, divisor_override=1)
        if divisor_override is not None:
            out = out / float(divisor_override)
        elif exclusive and any(p != (0, 0) for p in pairs):
            ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                              device=a.device)
            out = out / pool(pad_spatial(ones, pairs), ks, st,
                             divisor_override=1)
        else:
            out = out / float(math.prod(ks))
    if n == 1:
        out = out.squeeze(2)
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, 1, "NCL", ceil_mode,
                     return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, data_format,
                     ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, data_format,
                     ceil_mode, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, "NCL", ceil_mode,
                     exclusive, None)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, data_format,
                     ceil_mode, exclusive, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, data_format,
                     ceil_mode, exclusive, divisor_override)


_ADAPTIVE_AVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
                 3: F.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d,
                 3: F.adaptive_max_pool3d}


def _adaptive_avg(x, output_size, n, data_format):
    channel_last = data_format in _CHANNEL_LAST
    a = x.movedim(-1, 1) if channel_last else x
    out = _ADAPTIVE_AVG[n](a, output_size)
    return out.movedim(1, -1) if channel_last else out


def _adaptive_max(x, output_size, n, return_mask):
    res = _ADAPTIVE_MAX[n](x, output_size, return_indices=return_mask)
    return (res[0], res[1].int()) if return_mask else res


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_avg(x, output_size, 1, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_avg(x, output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_avg(x, output_size, 3, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 1, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 2, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 3, return_mask)
