"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py:14-84).

`cross_entropy` takes the log-softmax in fp32 whatever the logits' dtype,
as the JAX package does, and returns an fp32 loss; autograd carries the
logits' gradient back in their own dtype. Not a Pallas kernel in the JAX
package, so plain PyTorch here, on either device. An ignored target
(`label == ignore_index`) contributes 0 and is left out of the mean's
count; where every target is ignored the mean is 0.
"""
from __future__ import annotations

import torch


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy of `input` (logits, classes on `axis`)
    against hard labels (class ids shaped like `input` without `axis`, or
    with a trailing 1) or, with `soft_label`, probabilities shaped like
    `input`. `weight` [C] scales each target's term and the weighted mean
    divides by the summed weights of the targets kept;
    `label_smoothing` mixes a uniform distribution into the one-hot
    target; `use_softmax=False` reads `input` as probabilities."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    h = input.float().movedim(axis, -1)
    if use_softmax:
        logp = torch.log_softmax(h, dim=-1)
    else:
        logp = torch.log(h.clamp_min(1e-30))
    n_classes = h.shape[-1]
    if soft_label:
        soft = label.float().movedim(axis, -1)
        return _reduce(-(soft * logp).sum(-1), reduction)
    li = label.long()
    if li.ndim == input.ndim and li.shape[-1] == 1:
        li = li[..., 0]
    mask = li != ignore_index
    # an ignored id may lie outside [0, C): gather at 0, masked below
    safe = torch.where(mask, li, 0)
    if label_smoothing > 0.0:
        onehot = torch.nn.functional.one_hot(safe, n_classes).float()
        soft = onehot * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(soft * logp).sum(-1)
    else:
        loss = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(mask, loss, 0.0)
    if weight is not None:
        wv = torch.where(mask, weight.float()[safe], 0.0)
        loss = loss * wv
        if reduction == "mean":
            return loss.sum() / wv.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / mask.float().sum().clamp_min(1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-target loss, unreduced. A hard label with as many dims as
    `logits` (the trailing-1 form) gets its class axis back as 1 in the
    result, as in the JAX package; `return_softmax` adds
    softmax(logits)."""
    out = cross_entropy(logits, label, soft_label=soft_label,
                        ignore_index=ignore_index, reduction="none",
                        axis=axis)
    if not soft_label and label.ndim == logits.ndim:
        out = out.unsqueeze(axis)
    if return_softmax:
        return out, torch.softmax(logits, dim=axis)
    return out
