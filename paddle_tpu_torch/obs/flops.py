"""Analytic FLOPs and the card's peak (counterpart of
paddle_tpu/obs/flops.py).

`train_flops_per_step` is the 6·N·D formula for one transformer train
step, counting an MoE model's active parameters;
`conv_train_flops_per_step` a conv net's step from its forward MACs
(`paddle_tpu_torch.flops`); `decode_flops_per_token` and `decode_mfu`
the 2·N decode formula and the effective decode utilization the serving
economics ledger reports; `lora_decode_flops_per_token` an adapted row's
extra decode FLOPs; `peak_flops` is the published dense bf16 rate
of the card the port runs on. Stdlib only.
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


def train_flops_per_step(n_params: int, tokens_per_step: int,
                         expert_params: int = 0, moe_top_k: int = 2,
                         moe_num_experts: int = 0) -> float:
    """6·N·tokens: forward and backward FLOPs of one train step. An MoE
    model counts its ACTIVE parameters: a token runs top_k of the E
    experts, so the expert weights (`expert_params`, all of them, the
    gate excluded) count expert_params * top_k // E, rounded down as in
    the JAX package. With moe_num_experts 0 this is 6·N·D."""
    n_active = int(n_params)
    if moe_num_experts:
        n_active = (n_params - expert_params
                    + expert_params * moe_top_k // moe_num_experts)
    return 6.0 * n_active * tokens_per_step


def conv_train_flops_per_step(fwd_mac_flops: float, batch: int) -> float:
    """A conv net's train-step FLOPs from one sample's forward MACs:
    2 FLOPs a MAC, and forward plus backward ~ 3x the forward."""
    return 3.0 * (2.0 * float(fwd_mac_flops)) * batch


def decode_flops_per_token(n_params: int) -> float:
    """2·N forward-only FLOPs a generated token (KV-cache decode)."""
    return 2.0 * n_params


def lora_decode_flops_per_token(rank: int, target_dims) -> float:
    """Extra forward FLOPs a token for one LoRA-adapted row: each adapted
    site adds ``x[in] @ A.T[in, r]`` then ``z[r] @ B.T[r, out]``, 2·r·(in +
    out) FLOPs under decode_flops_per_token's 2·MAC convention.
    `target_dims` holds one (in_features, out_features) pair for EVERY
    adapted site of EVERY layer (num_layers * len(targets) entries)."""
    r = int(rank)
    return float(sum(2.0 * r * (int(i) + int(o)) for i, o in target_dims))


def decode_mfu(flops_per_token: float, tokens: int, seconds: float,
               peak_flops_total: float):
    """Effective decode MFU: decode FLOP/s achieved over the peak. None
    when an input is degenerate (no tokens, no seconds, no peak)."""
    if not (flops_per_token and tokens and seconds and peak_flops_total):
        return None
    if seconds <= 0 or peak_flops_total <= 0:
        return None
    return flops_per_token * tokens / seconds / peak_flops_total
