"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py:15-110).

layer_norm keeps fp32 statistics and casts back to the input dtype, and
is differentiable. On CUDA, a last-axis norm with weight and bias goes to
the hand-written LayerNorm kernels (ops/layernorm.py: the forward kernel,
and the backward kernel for its gradient); every other case, and every
CPU tensor, takes the plain math in the JAX package's op order, with
autograd through it.

batch_norm is plain `lax`/`jnp` in the JAX package, so here it is
`F.batch_norm` (cuDNN or ATen's kernels on the card), with the JAX
function's rules: statistics in fp32 whatever the input's dtype, the
output in the input's dtype; normalised with the batch's biased variance
as (x - mean) / sqrt(var + eps) where it uses batch statistics
(`training and not use_global_stats`), with the running ones otherwise;
the running statistics moved in place with the unbiased variance
(n / (n - 1)) and Paddle's momentum, the weight of the OLD value
(running = m · running + (1 - m) · batch; `F.batch_norm` takes 1 - m),
computed in fp32 and rounded once to the buffers' dtype (bf16 buffers
after `model.to(torch.bfloat16)`, as the JAX `Layer.to` casts them). The
channel axis is 1, or the last with a channel-last `data_format` and more
than 2 dims; [N, C] reduces over N. A recomputed forward
(`distributed/fleet/utils/recompute.replaying()`) normalises with the
batch's statistics but leaves the running ones alone: they move once a
step, as in the JAX step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...distributed.fleet.utils.recompute import replaying


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape)
    if (n_axes == 1 and weight is not None and bias is not None
            and x.ndim >= 2):
        from ...ops.layernorm import fused_layer_norm
        return fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.ndim - n_axes, x.ndim))
    h = x.float()
    mu = h.mean(dim=axes, keepdim=True)
    var = (h - mu).square().mean(dim=axes, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


_LOW = (torch.bfloat16, torch.float16)


def _channel_axis(ndim, data_format):
    if ndim <= 2:
        return 1 if ndim == 2 else 0
    return ndim - 1 if data_format[-1] == "C" else 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    use_batch_stats = bool(training and not use_global_stats)
    ch = _channel_axis(x.ndim, data_format)
    a = x.unsqueeze(0) if x.ndim == 1 else (x if ch == 1
                                            else x.movedim(ch, 1))
    w, b, rm, rv = weight, bias, running_mean, running_var
    # F.batch_norm takes weight, bias and buffers in x's dtype, or all in
    # fp32 beside a bf16/fp16 x (mixed). Its CPU kernel rounds its
    # per-channel scale and shift to a bf16 x's dtype when they are bf16,
    # so the CPU runs bf16 mixed; any other mix runs on fp32 copies too
    # (the buffers' written back)
    given = [t for t in (w, b, rm, rv) if t is not None]
    mixed = a.dtype in _LOW and all(t.dtype == torch.float32 for t in given)
    same = all(t.dtype == a.dtype for t in given)
    if not (mixed or (same and not (a.dtype in _LOW and a.device.type
                                    == "cpu"))):
        w = None if w is None else w.float()
        b = None if b is None else b.float()
        rm, rv = rm.float(), rv.float()
        if a.dtype not in _LOW:
            a = a.float()
    update = use_batch_stats and not replaying()
    if use_batch_stats:
        if not update:
            # a recomputed forward must save what the first run saved:
            # statistics buffers, here copies that nothing reads again
            rm, rv = rm.clone(), rv.clone()
        out = F.batch_norm(a, rm, rv, w, b, training=True,
                           momentum=1.0 - momentum, eps=epsilon)
    else:
        out = F.batch_norm(a, rm, rv, w, b, training=False, eps=epsilon)
    if update and rm is not running_mean:
        with torch.no_grad():
            running_mean.copy_(rm)
            running_var.copy_(rv)
    out = out.to(x.dtype)
    if x.ndim == 1:
        return out[0]
    return out if ch == 1 else out.movedim(1, ch)
