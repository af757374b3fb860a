"""Gathered per-row low-rank (LoRA) delta for multi-adapter batched decode
(counterpart of paddle_tpu/ops/lora.py).

One unified step serves K adapters at once: the bank stacks every
adapter's factors as ``A [K, r, in]`` / ``B [K, out, r]`` tensors and
each batch row carries an ``adapter_idx`` into the stack. The delta is a
gathered per-row low-rank product, so adapters churn without changing
the step's shapes or its launches. Row 0 of the bank is all zeros:
``x @ 0 @ 0`` is exact zeros, so ``adapter=None`` rows (idx 0) stay
bit-equal to the base model.

The JAX package computes these as einsums outside any Pallas kernel;
here they are `torch.bmm`/`torch.matmul` in fp32 in the same order:
gather A and B by idx, cast x to fp32, the two products, times
``scale[idx]``, cast to x's dtype, then added to y in y's dtype.
"""
from __future__ import annotations

import torch


def lora_delta(x, A, B, idx, scale):
    """Per-row low-rank delta, gathered from stacked adapter banks.

    x:     [B, T, in]   activations entering the adapted projection
    A:     [K, r, in]   stacked down-projections
    B:     [K, out, r]  stacked up-projections
    idx:   [B] int      bank row per batch row (0 = base pass-through)
    scale: [K] float32  per-adapter alpha/rank scaling

    Returns [B, T, out] in x.dtype. Each batch row touches only its own
    bank row, so a mixed batch matches per-adapter solo decode."""
    idx = idx.long()
    Ag = A.index_select(0, idx)                       # [B, r, in]
    Bg = B.index_select(0, idx)                       # [B, out, r]
    z = torch.bmm(x.float(), Ag.float().transpose(1, 2))   # [B, T, r]
    d = torch.bmm(z, Bg.float().transpose(1, 2))           # [B, T, out]
    d = d * scale.index_select(0, idx)[:, None, None]
    return d.to(x.dtype)


def lora_matmul(x, A, B):
    """Un-gathered low-rank product ``(x @ A^T) @ B^T`` for one adapter.

    The training path behind `LoRALinear`: x [..., in], A [r, in],
    B [out, r] -> [..., out] in float32 (the caller scales and casts)."""
    z = torch.matmul(x.float(), A.float().t())
    return torch.matmul(z, B.float().t())


def add_lora_delta(y, x, entry, idx, scale):
    """Add the gathered delta of one projection site to its output `y`.

    `entry` is the site's ``(A, B)`` bank tensors, or None when the site
    is not adapted: `y` then passes through untouched."""
    if entry is None:
        return y
    A, B = entry
    return y + lora_delta(x, A, B, idx, scale).to(y.dtype)
