"""Analytic FLOPs and the card's peak (counterpart of
paddle_tpu/obs/flops.py).

`train_flops_per_step` is the 6·N·D formula for one dense-transformer
train step; `peak_flops` is the published dense bf16 rate of the card the
port runs on. Stdlib only.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s, no sparsity
H100_BF16_PEAK_FLOPS = 989e12


def peak_flops(device_name: str) -> float:
    """Dense bf16 peak FLOP/s of the card named `device_name` (as
    torch.cuda.get_device_name gives it). Raises KeyError for a card other
    than an H100 SXM (the PCIe card's peak is lower): an MFU is never
    computed against a guessed peak."""
    name = (device_name or "").lower()
    if "h100" in name and "pcie" not in name:
        return H100_BF16_PEAK_FLOPS
    raise KeyError(f"no published peak for {device_name!r}")


def train_flops_per_step(n_params: int, tokens_per_step: int) -> float:
    """6·N·tokens: forward and backward FLOPs of one dense train step."""
    return 6.0 * int(n_params) * tokens_per_step
