"""Non-finite census (counterpart of paddle_tpu/obs/numerics.py:79).

Only `all_finite`, which the loss scalers share, is ported; the rest of
the numerics observatory (per-group norms, blame probes) waits for its
own slice (ROADMAP §1 item 7f).
"""
from __future__ import annotations

import torch


def all_finite(tensors):
    """0-d bool tensor: every element of every tensor is finite. One
    reduction a tensor and one over their results, on the tensors' device:
    nothing waits for the host. True for an empty list."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()
