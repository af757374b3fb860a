"""Attention (counterpart of paddle_tpu/ops/attention.py).

Two parts. `flash_attention` is the no-cache attention of training: the
TPU kernels `_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel` become
the hand-written CUDA kernels in `csrc/flash_attention.cu` (the bf16
forward, dq and dk/dv run on the tensor cores, `csrc/flash_attention_tc.cu`),
tied together by `FlashAttentionFn` (the JAX package's custom_vjp).
Their plain PyTorch versions run the same arithmetic on whole score matrices
(`_attention_reference`'s op sequence, plus lse and the JAX backward
kernels' formulas); a CPU tensor takes them and a CUDA tensor launches
the kernels. The TPU-only dispatch rules (S >= 512, block divisibility,
FLAGS_flash_attention) are not carried over: on CUDA the kernels always
run. The additive mask and in-kernel dropout (reached only through
`scaled_dot_product_attention`) wait for their slice: on CUDA they raise.

The static-cache decode primitives (attention.py:714-786) are one numeric
path shared by GPT's cached forward, one-shot generate() and the serving
engine's unified step: masked columns score _NEG_INF and contribute an
exact 0, so padded cache tails and foreign rows never perturb a row's
softmax.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _kernels
from .paged_attention import (DEFAULT_KV_BLOCK, ragged_paged_attention,
                              trivial_block_table)

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_MASK_DROPOUT_SLICE = (
    "flash_attention's additive mask and dropout on CUDA wait for the "
    "scaled_dot_product_attention slice (ROADMAP §1, modules still "
    "missing: mask and dropout variants of kernels 3-5)")


def causal_mask(n_rows: int, n_cols: int, q_offset=0, k_offset=0,
                device=None):
    """Boolean [n_rows, n_cols]: True where query position >= key position
    (with absolute offsets)."""
    rows = torch.arange(n_rows, device=device)[:, None]
    cols = torch.arange(n_cols, device=device)[None, :]
    return (q_offset + rows) >= (k_offset + cols)


def _attention_reference(q, k, v, causal, scale, mask=None):
    """Plain attention (fp32 softmax), the JAX package's XLA reference:
    q [B, H, Sq, D], k/v [B, H, Sk, D], optional additive mask
    [B, 1|H, Sq, Sk] or [B, Sq, Sk]. Differentiable by autograd."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    Sq, Sk = logits.shape[-2], logits.shape[-1]
    cm = None
    if causal:
        cm = causal_mask(Sq, Sk, q_offset=Sk - Sq, device=q.device)
        logits = torch.where(cm, logits, _NEG_INF)
    if mask is not None:
        if mask.ndim == 3:
            mask = mask[:, None]
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if cm is not None:
        # rows with no causally visible key (Sq > Sk) output zeros
        probs = torch.where(cm.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.matmul(probs.to(q.dtype).float(),
                        v.float()).to(q.dtype)


def _masked_scores(q, k, causal, scale):
    """s = (q . k) in fp32 * scale, masked to _NEG_INF (causal, bottom-right
    aligned): [B, H, Sq, Sk] fp32 and the boolean visibility."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    Sq, Sk = s.shape[-2], s.shape[-1]
    if not causal:
        return s, None
    cm = causal_mask(Sq, Sk, q_offset=Sk - Sq, device=q.device)
    return torch.where(cm, s, _NEG_INF), cm


def flash_fwd_plain(q, k, v, causal, scale):
    """The forward kernel's function in PyTorch on whole score rows:
    (out in q's dtype, lse [B, H, Sq] fp32). Masked scores give an exact
    0, l is floored at 1e-30 (a row with no visible key outputs 0), and
    p is rounded to v's dtype before PV."""
    s, _ = _masked_scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_bwd_plain(q, k, v, g, lse, delta, causal, scale):
    """The dq and dk/dv kernels' arithmetic in PyTorch: p = exp(s - lse)
    (exact 0 where masked), dp = g . v, ds = p * (dp - delta) * scale;
    dq = ds(k's dtype) @ k, dv = p(g's dtype)^T @ g, dk = ds(q's dtype)^T
    @ q, each summed in fp32 and cast to its input's dtype."""
    s, _ = _masked_scores(q, k, causal, scale)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2),
                      g.float()).to(v.dtype)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()).to(k.dtype)
    return dq, dk, dv


def _check_qkv(q, k, v, what):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, H, Sq, D] and k, v one "
                         f"[B, H, Sk, D], got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in B, H or D")
    if D % 16 or not 16 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take a head_dim that is "
                         f"a multiple of 16 up to {MAX_HEAD_DIM}, got {D}")
    if B * H > 65535 or Sq < 1 or k.shape[2] < 1:
        raise ValueError(f"flash attention kernels take 1 <= B*H <= 65535 "
                         f"and non-empty sequences, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernels take contiguous tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype == torch.bfloat16:
        _check_aligned((q, k, v))
    return B, H, Sq, k.shape[2], D


def _check_aligned(tensors):
    """The bf16 tensor-core kernels read their inputs by TMA, which takes
    16-byte aligned addresses."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 flash attention kernels take tensors whose "
                         "data starts on a 16-byte boundary")


def flash_fwd_cuda(q, k, v, causal, scale):
    """Launch the forward kernel. Returns (out, lse [B, H, Sq] fp32)."""
    B, H, Sq, Sk, D = _check_qkv(q, k, v, "flash_fwd_cuda")
    code = _kernels.dtype_code(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
    lib = _kernels.load_library()
    rc = lib.pdtt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, Sq, Sk, D, float(scale), int(bool(causal)),
        code, _kernels.current_stream_handle(q.device))
    _kernels.check_launch(rc, "flash_fwd")
    _kernels.LAUNCHES["flash_fwd"] += 1
    return out, lse


def _check_grad_side(q, g, lse, delta):
    B, H, Sq, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {tuple(q.shape)} "
                         f"{q.dtype} tensor, got {tuple(g.shape)} {g.dtype}")
    if g.dtype == torch.bfloat16:
        _check_aligned((g,))
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous [B, H, Sq] "
                             f"float32 tensor on q's device, got "
                             f"{tuple(t.shape)} {t.dtype}")


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale):
    """Launch the dq kernel. Returns dq in q's dtype."""
    B, H, Sq, Sk, D = _check_qkv(q, k, v, "flash_bwd_dq_cuda")
    _check_grad_side(q, g, lse, delta)
    code = _kernels.dtype_code(q.dtype)
    dq = torch.empty_like(q)
    lib = _kernels.load_library()
    rc = lib.pdtt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, Sq, Sk, D,
        float(scale), int(bool(causal)), code,
        _kernels.current_stream_handle(q.device))
    _kernels.check_launch(rc, "flash_bwd_dq")
    _kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale):
    """Launch the dk/dv kernel. Returns (dk, dv) in k's dtype."""
    B, H, Sq, Sk, D = _check_qkv(q, k, v, "flash_bwd_dkv_cuda")
    _check_grad_side(q, g, lse, delta)
    code = _kernels.dtype_code(q.dtype)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.load_library()
    rc = lib.pdtt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, Sq, Sk, D, float(scale), int(bool(causal)), code,
        _kernels.current_stream_handle(q.device))
    _kernels.check_launch(rc, "flash_bwd_dkv")
    _kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_delta(g, out):
    """delta = rowsum(g * out) in fp32 [B, H, Sq]: computed outside the
    kernels, as the JAX package does."""
    return (g.float() * out.float()).sum(dim=-1)


def flash_fwd(q, k, v, causal, scale):
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal, scale)
    return flash_fwd_plain(q, k, v, causal, scale)


def flash_bwd(q, k, v, out, lse, g, causal, scale):
    """(dq, dk, dv): the two backward kernels on CUDA, the plain version
    on the CPU."""
    delta = flash_attention_delta(g, out)
    if q.is_cuda:
        dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale)
        return dq, dk, dv
    return flash_bwd_plain(q, k, v, g, lse, delta, causal, scale)


class FlashAttentionFn(torch.autograd.Function):
    """out = attention(q, k, v) by the forward kernel, saving out and lse;
    the gradient by the dq and dk/dv kernels (the JAX package's
    _flash_vjp_fwd / _flash_vjp_bwd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale=None, mask=None,
                    dropout_p: float = 0.0):
    """q: [B, H, Sq, D], k/v: [B, H, Sk, D]. Returns [B, H, Sq, D] in q's
    dtype. Causal masking is bottom-right aligned when Sq != Sk; a row
    with no visible key outputs 0. Differentiable.

    CUDA tensors go through the forward, dq and dk/dv kernels (D a
    multiple of 16 up to 128, fp32 or bf16, any sequence lengths); CPU
    tensors through their plain versions. An additive `mask` runs the
    plain reference on the CPU and raises on CUDA; `dropout_p > 0` raises
    on both (the TPU's random bits cannot be reproduced)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_p > 0.0:
        raise NotImplementedError(_MASK_DROPOUT_SLICE)
    if mask is not None:
        if q.is_cuda:
            raise NotImplementedError(_MASK_DROPOUT_SLICE)
        return _attention_reference(q, k, v, causal, scale, mask)
    q, k, v = (t.contiguous() for t in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, scale)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write k/v [B, Hkv, T, D] into static [B, Hkv, L, D] caches at `pos`,
    IN PLACE (the JAX package returns new slabs; here the slabs are
    mutated and also returned, so callers read the same either way).

    `pos` is the absolute position of the first new token: an int writes
    every row at one offset, a [B] tensor each row at its own. The start
    is clamped to [0, L - T] exactly as `lax.dynamic_update_slice` clamps
    it, so a write that would overrun the cache lands in the same columns
    as on the JAX side.
    """
    L = k_cache.shape[2]
    T = k_new.shape[2]
    if T > L:
        raise ValueError(f"cannot write {T} tokens into a cache of {L}")
    k_new = k_new.to(k_cache.dtype)
    v_new = v_new.to(v_cache.dtype)
    if not torch.is_tensor(pos) or pos.ndim == 0:
        start = min(max(int(pos), 0), L - T)
        k_cache[:, :, start:start + T] = k_new
        v_cache[:, :, start:start + T] = v_new
        return k_cache, v_cache
    B = k_cache.shape[0]
    start = pos.to(device=k_cache.device, dtype=torch.long).clamp(0, L - T)
    cols = start[:, None] + torch.arange(T, device=k_cache.device)  # [B, T]
    rows = torch.arange(B, device=k_cache.device)[:, None]
    # advanced indices around a slice put the indexed dims first: [B,T,H,D]
    k_cache[rows, :, cols] = k_new.transpose(1, 2)
    v_cache[rows, :, cols] = v_new.transpose(1, 2)
    return k_cache, v_cache


def decode_attention(q, k_cache, v_cache, pos, scale=None, paged=None):
    """Length-masked attention of q [B, H, T, D] over static caches
    [B, Hkv, L, D] (GQA: Hkv divides H).

    `pos` — an int or a [B] tensor — is the absolute position of q's first
    token in each row; cache columns beyond pos+t are masked. With
    `paged=None` each row attends its own contiguous cache through a
    trivial block table at DEFAULT_KV_BLOCK; `paged=(block_table,
    seq_lens, block_len, pages_per_row)` addresses slot-pool pages
    directly (the serving engine's mixed prefill/decode step). Both go
    through `ragged_paged_attention`, so streams agree between the two
    callers at a shared block size.
    """
    B, H, T, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    if paged is not None:
        block_table, seq_lens, block_len, pages_per_row = paged
        return ragged_paged_attention(
            q, k_cache, v_cache, block_table, seq_lens,
            _row_positions(pos, B, dev), block_len=int(block_len),
            pages_per_row=int(pages_per_row), scale=scale)
    L = k_cache.shape[2]
    table, nb = trivial_block_table(B, L, DEFAULT_KV_BLOCK, device=dev)
    pad = nb * DEFAULT_KV_BLOCK - L
    if pad:
        k_cache = F.pad(k_cache, (0, 0, 0, pad))
        v_cache = F.pad(v_cache, (0, 0, 0, pad))
    q_pos = _row_positions(pos, B, dev)
    seq_lens = q_pos + T
    return ragged_paged_attention(q, k_cache, v_cache, table, seq_lens,
                                  q_pos, block_len=DEFAULT_KV_BLOCK,
                                  pages_per_row=nb, scale=scale)


def _row_positions(pos, B, device):
    """An int or a 0-d/[B] tensor -> [B] int32 tensor on `device`."""
    if torch.is_tensor(pos) and pos.ndim == 1:
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)
