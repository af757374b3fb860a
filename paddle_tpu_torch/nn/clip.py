"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

`clip_grad_norm_` clips the `.grad` of parameters in place, as the JAX
function does. Each class is called on a list of (param, grad) pairs and
returns a new list, with the math of the JAX package's compiled train path
(`Optimizer.clip_gradients_fn`, paddle_tpu/optimizer/optimizer.py:185-218):
norms in fp32, each gradient scaled in fp32 and cast back to its dtype.
The train steps hand the pairs over sorted by parameter name, the order
of the JAX path's pytree leaves.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient alone to at most `clip_norm`."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            g32 = g.float()
            n = g32.square().sum().sqrt()
            f = torch.clamp_max(self.clip_norm / n.clamp_min(1e-12), 1.0)
            out.append((p, (g32 * f).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients together to a global norm of at most `clip_norm`:
    factor = min(clip_norm / max(norm, clip_norm), 1). A parameter whose
    `need_clip` is False is left out of the norm and its gradient passes
    through untouched, as in the JAX class."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not grads:
            return list(params_grads)
        gsq = torch.stack([g.float().square().sum() for g in grads]).sum()
        gnorm = gsq.sqrt()
        f = torch.clamp_max(
            self.clip_norm / gnorm.clamp_min(self.clip_norm), 1.0)
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else (g.float() * f).to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every parameter's gradient in place so that their joint
    `norm_type` norm is at most `max_norm`: factor = min(max_norm /
    max(norm, 1e-6), 1), gradients scaled in fp32 and cast back. Returns
    the norm (0-d fp32; 0 with no gradient). `error_if_nonfinite` raises
    RuntimeError on a non-finite norm, which costs one host read; by
    default nothing waits for the host and a non-finite norm scales as it
    is (inf gives zeros, NaN spreads). The JAX function
    (paddle_tpu/nn/clip.py:79), op for op."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max().float()
                             for p in params]).max()
    else:
        total = torch.stack([p.grad.float().abs().pow(norm_type).sum()
                             for p in params]).sum().pow(1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"The total norm of order {norm_type} for gradients from "
            "`parameters` is non-finite, so it cannot be clipped. To "
            "disable this error and scale the gradients with the "
            "non-finite norm anyway, set error_if_nonfinite=False")
    factor = torch.clamp_max(max_norm / total.clamp_min(1e-6), 1.0)
    for p in params:
        p.grad = (p.grad.float() * factor).to(p.grad.dtype)
    return total
