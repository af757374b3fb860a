"""Attention (counterpart of paddle_tpu/ops/attention.py).

Two parts. `flash_attention` is the no-cache attention of training: the
TPU kernels `_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel` become
the hand-written CUDA kernels in `csrc/flash_attention.cu` (the bf16
and fp16 forward, dq and dk/dv, each with its mask and dropout variants,
run on the tensor cores, `csrc/flash_attention_tc.cu`), tied together by
`FlashAttentionFn` (the JAX package's custom_vjp).
Their plain PyTorch versions run the same arithmetic on whole score matrices
(`_attention_reference`'s op sequence, plus lse and the JAX backward
kernels' formulas); a CPU tensor takes them and a CUDA tensor launches
the kernels. The TPU-only dispatch rules (S >= 512, block divisibility,
FLAGS_flash_attention) are not carried over: on CUDA the kernels always
run. The additive mask and in-kernel dropout are variants of the same
three kernels (reached through `scaled_dot_product_attention`,
`incubate.flash_attention` or `flash_attention(mask=, dropout_p=)`);
dropout's keep-mask is Philox4x32-10 keyed per element
(`dropout_keep_mask`), so the kernels and the plain versions draw the
same bits.

The static-cache decode primitives (attention.py:714-786) are one numeric
path shared by GPT's cached forward, one-shot generate() and the serving
engine's unified step: masked columns score _NEG_INF and contribute an
exact 0, so padded cache tails and foreign rows never perturb a row's
softmax.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from . import _kernels
from .paged_attention import (DEFAULT_KV_BLOCK, ragged_paged_attention,
                              trivial_block_table)

_NEG_INF = -1e30
MAX_HEAD_DIM = 128


def causal_mask(n_rows: int, n_cols: int, q_offset=0, k_offset=0,
                device=None):
    """Boolean [n_rows, n_cols]: True where query position >= key position
    (with absolute offsets)."""
    rows = torch.arange(n_rows, device=device)[:, None]
    cols = torch.arange(n_cols, device=device)[None, :]
    return (q_offset + rows) >= (k_offset + cols)


def _mask_4d(mask):
    """An additive mask as a 4-D tensor broadcastable to [B, H, Sq, Sk]:
    [B, Sq, Sk] gets a head axis, as the JAX package's `_mask_3d` and
    reference do."""
    if mask.ndim == 3:
        return mask[:, None]
    if mask.ndim != 4:
        raise ValueError(f"an additive mask is [B|1, H|1, Sq, Sk] or "
                         f"[B, Sq, Sk], got {tuple(mask.shape)}")
    return mask


def _attention_reference(q, k, v, causal, scale, mask=None, dropout_p=0.0,
                         keep=None):
    """Plain attention (fp32 softmax), the JAX package's XLA reference:
    q [B, H, Sq, D], k/v [B, H, Sk, D], optional additive mask
    [B, 1|H, Sq, Sk] or [B, Sq, Sk]; with dropout_p > 0 the kept
    probabilities (`keep`, bool [B, H, Sq, Sk]) are scaled by
    1 / (1 - dropout_p) and the rest dropped. Differentiable by autograd,
    in the mask too."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    Sq, Sk = logits.shape[-2], logits.shape[-1]
    cm = None
    if causal:
        cm = causal_mask(Sq, Sk, q_offset=Sk - Sq, device=q.device)
        logits = torch.where(cm, logits, _NEG_INF)
    if mask is not None:
        logits = logits + _mask_4d(mask).float()
    probs = torch.softmax(logits, dim=-1)
    if cm is not None:
        # rows with no causally visible key (Sq > Sk) output zeros
        probs = torch.where(cm.any(dim=-1, keepdim=True), probs, 0.0)
    if dropout_p > 0.0:
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.matmul(probs.to(q.dtype).float(),
                        v.float()).to(q.dtype)


# ---- dropout's keep-mask: Philox4x32-10, keyed per element
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a, m):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64
    tensors: a 32 x 32-bit product overflows int64, so a is split into
    16-bit halves (each partial product stays below 2**48)."""
    t = (a & 0xFFFF) * m
    u = (a >> 16) * m
    x = t + ((u & 0xFFFF) << 16)
    return (u >> 16) + (x >> 32), x & _U32


def philox4x32_10(c0, c1, c2, c3, key0, key1):
    """Random123's Philox4x32-10 over broadcastable int64 tensors of
    uint32 counter words, key (key0, key1) python ints: the four output
    words, as `csrc/philox.cuh` computes them."""
    k0, k1 = key0 & _U32, key1 & _U32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(p: float) -> int:
    """The uint32 below which a Philox word drops its element: the JAX
    package's `_block_keep` threshold."""
    return int(p * (2 ** 32 - 1))


def dropout_keep_mask(seed: int, B: int, H: int, Sq: int, Sk: int,
                      p: float, device=None):
    """The kernels' keep-mask in plain PyTorch: bool [B, H, Sq, Sk].

    Element (bh = b*H + h, query row i, key column j) is kept when word
    j & 3 of Philox4x32-10(counter=(j >> 2, i, bh, 0), key=(seed mod 2**32,
    seed >> 32)) is >= dropout_threshold(p). Keyed per element, so every
    kernel (forward, dq, dk/dv, whatever its tiles) and this version draw
    the same bit. The JAX package draws its bits from the TPU PRNG per
    tile; those cannot be reproduced."""
    seed = int(seed) & ((1 << 64) - 1)
    i64 = dict(dtype=torch.int64, device=device)
    groups = (Sk + 3) // 4
    words = philox4x32_10(torch.arange(groups, **i64)[None, None, :],
                          torch.arange(Sq, **i64)[None, :, None],
                          torch.arange(B * H, **i64)[:, None, None],
                          torch.zeros((), **i64), seed & _U32, seed >> 32)
    bits = torch.stack(words, dim=-1).reshape(B * H, Sq, 4 * groups)
    keep = bits[..., :Sk] >= dropout_threshold(p)
    return keep.reshape(B, H, Sq, Sk)


def _masked_scores(q, k, causal, scale, mask=None):
    """s = (q . k) in fp32 * scale; causal entries (bottom-right aligned)
    set to _NEG_INF, then the additive mask summed in fp32: the TPU
    kernels' `_apply_mask_block` order. [B, H, Sq, Sk] fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    Sq, Sk = s.shape[-2], s.shape[-1]
    if causal:
        cm = causal_mask(Sq, Sk, q_offset=Sk - Sq, device=q.device)
        s = torch.where(cm, s, _NEG_INF)
    if mask is not None:
        s = s + _mask_4d(mask).float()
    return s


def _dropped(x, keep, dropout_p):
    """keep ? x / (1 - p) : 0, the multiply by the fp32 reciprocal the
    kernels use."""
    return torch.where(keep, x * (1.0 / (1.0 - dropout_p)), 0.0)


def flash_fwd_plain(q, k, v, causal, scale, mask=None, keep=None,
                    dropout_p=0.0):
    """The forward kernel's function in PyTorch on whole score rows:
    (out in q's dtype, lse [B, H, Sq] fp32). p = 0 exactly where the
    masked score is <= -5e29; the row max starts at -1e30, as the
    kernel's running max does, and l (the sum of the undropped p) is
    floored at 1e-30, so a row with no visible key outputs 0. With
    dropout_p > 0 the PV numerator takes the dropped p (`keep`); p is
    rounded to v's dtype before PV."""
    s = _masked_scores(q, k, causal, scale, mask)
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_p > 0.0:
        p = _dropped(p, keep, dropout_p)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_bwd_plain(q, k, v, g, lse, delta, causal, scale, mask=None,
                    keep=None, dropout_p=0.0):
    """The dq and dk/dv kernels' arithmetic in PyTorch: p = exp(s - lse)
    (exact 0 where masked), dp = g . v, dropped with `keep` when
    dropout_p > 0, ds = p * (dp - delta) * scale with the undropped p;
    dq = ds(k's dtype) @ k, dv = p_dropped(g's dtype)^T @ g, dk = ds(q's
    dtype)^T @ q, each summed in fp32 and cast to its input's dtype."""
    s = _masked_scores(q, k, causal, scale, mask)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    p_v = p
    if dropout_p > 0.0:
        dp = _dropped(dp, keep, dropout_p)
        p_v = _dropped(p, keep, dropout_p)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)
    dv = torch.matmul(p_v.to(g.dtype).float().transpose(-1, -2),
                      g.float()).to(v.dtype)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()).to(k.dtype)
    return dq, dk, dv


def _check_mask(mask, B, H, Sq, Sk):
    """The 4-D additive mask `mask` broadcasts as the kernels read it: a
    batch dim of 1 or B, a head dim of 1 or H, Sq and Sk or 1. Raises
    ValueError otherwise."""
    mb, mh = mask.shape[0], mask.shape[1]
    if mb not in (1, B):
        raise ValueError(
            f"additive mask batch dim {mb} must be 1 or match batch {B}")
    if mh not in (1, H):
        raise ValueError(
            f"additive mask head dim {mh} must be 1 or match heads {H}")
    if mask.shape[2] not in (1, Sq) or mask.shape[3] not in (1, Sk):
        raise ValueError(f"additive mask {tuple(mask.shape)} does not "
                         f"broadcast to [{B}, {H}, {Sq}, {Sk}]")


def _mask_3d(mask, B, H, Sq, Sk):
    """An additive mask as [rows, Sq, Sk] and the divisor that maps a
    batch*head index to its row (row = bh // divisor), as the JAX
    package's `_mask_3d`: [B, 1, Sq, Sk] stays unbroadcast (divisor H),
    [1, 1, ...] is one row (divisor B*H), [B|1, H, ...] is flattened to
    B*H rows. Size-1 Sq or Sk dims are expanded. A batch dim other than
    1 or B raises ValueError."""
    mask = _mask_4d(mask)
    _check_mask(mask, B, H, Sq, Sk)
    mb, mh = mask.shape[0], mask.shape[1]
    if mh == 1:
        return mask.expand(mb, 1, Sq, Sk).reshape(mb, Sq, Sk), (
            B * H if mb == 1 else H)
    flat = mask.expand(B, H, Sq, Sk).reshape(B * H, Sq, Sk)
    return flat, 1


def _mask_grad(q, k, v, mask, lse, g, delta, causal, scale, keep=None,
               dropout_p=0.0):
    """d(loss)/d(additive mask) in plain PyTorch: the cotangent at the
    mask-add point is p * (dp - delta) (no scale: the mask is added after
    the scaling), dp dropped as in dq when dropout_p > 0; reduced over
    the mask's broadcast dims and returned in its shape and dtype. The
    JAX package computes it in XLA, outside any kernel."""
    s = _masked_scores(q, k, causal, scale, mask)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    if dropout_p > 0.0:
        dp = _dropped(dp, keep, dropout_p)
    dm = p * (dp - delta[..., None])
    m4 = _mask_4d(mask)
    dims = [d for d in range(4) if m4.shape[d] == 1 and dm.shape[d] != 1]
    if dims:
        dm = dm.sum(dim=dims, keepdim=True)
    return dm.reshape(mask.shape).to(mask.dtype)


def _kernel_mask(mask, B, H, Sq, Sk):
    """The additive mask once in the layout the kernels read: fp32,
    contiguous, [B|1, 1|H, Sq, Sk] with a per-head mask's batch expanded,
    so that `_mask_3d` of it is a view. FlashAttentionFn converts a mask
    once a forward and hands the result to all three kernels; a mask
    already in this layout is taken without a copy."""
    mask = _mask_4d(mask)
    _check_mask(mask, B, H, Sq, Sk)
    mh = mask.shape[1]
    rows = B if mh == H else mask.shape[0]
    return mask.float().expand(rows, mh, Sq, Sk).contiguous()


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
    if q.dtype in _TC_DTYPES:
        _check_aligned((q, k, v))
    return B, H, Sq, k.shape[2], D


# the 16-bit types the tensor-core kernels take (fp32 runs the scalar ones)
_TC_DTYPES = (torch.bfloat16, torch.float16)


def _check_aligned(tensors):
    """The bf16 and fp16 tensor-core kernels read their inputs by TMA,
    which takes 16-byte aligned addresses."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 and fp16 flash attention kernels take tensors "
                         "whose data starts on a 16-byte boundary")


def _variant(q, Sk, mask, dropout_p, seed):
    """(fp32 mask rows or None, the C entry points' trailing variant
    arguments: mask pointer (0: none), row divisor, seed, dropout_p, and
    the launch counter's suffix: "_mask", "_dropout" or ""; an fp16
    instantiation's counter adds "_fp16", `_kernels.fp16_name`). The
    caller holds the rows until the launch. A mask and dropout together
    are refused: flash_attention sends them to the plain reference, by
    the JAX package's rule."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    B, H, Sq, _ = q.shape
    if mask is None:
        if dropout_p > 0.0:
            return None, (0, 1, int(seed) & ((1 << 64) - 1),
                          float(dropout_p)), "_dropout"
        return None, (0, 1, 0, 0.0), ""
    if dropout_p > 0.0:
        raise ValueError("the flash kernels take an additive mask or "
                         "dropout, not both: flash_attention runs the two "
                         "together through the plain reference")
    if mask.device != q.device:
        raise ValueError("the additive mask must be on q's device")
    if not mask.is_floating_point():
        raise TypeError(f"the additive mask must be a float tensor, got "
                        f"{mask.dtype}")
    rows, div = _mask_3d(_kernel_mask(mask, B, H, Sq, Sk), B, H, Sq, Sk)
    return rows, (rows.data_ptr(), div, 0, 0.0), "_mask"


def flash_fwd_cuda(q, k, v, causal, scale, mask=None, dropout_p=0.0,
                   seed=0):
    """Launch the forward kernel. Returns (out, lse [B, H, Sq] fp32).
    `mask`: an additive mask broadcastable to [B, H, Sq, Sk] (any float
    dtype, summed in fp32); `dropout_p > 0`: in-kernel dropout keyed by
    `seed` (dropout_keep_mask's contract)."""
    B, H, Sq, Sk, D = _check_qkv(q, k, v, "flash_fwd_cuda")
    rows, extra, suffix = _variant(q, Sk, mask, dropout_p, seed)
    code = _kernels.dtype_code(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
    lib = _kernels.load_library()
    rc = lib.pdtt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, Sq, Sk, D, float(scale), int(bool(causal)),
        *extra, code,
        _kernels.current_stream_handle(q.device))
    name = _kernels.fp16_name("flash_fwd" + suffix, q.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    return out, lse


def _check_grad_side(q, g, lse, delta):
    B, H, Sq, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {tuple(q.shape)} "
                         f"{q.dtype} tensor, got {tuple(g.shape)} {g.dtype}")
    if g.dtype in _TC_DTYPES:
        _check_aligned((g,))
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous [B, H, Sq] "
                             f"float32 tensor on q's device, got "
                             f"{tuple(t.shape)} {t.dtype}")


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, mask=None,
                      dropout_p=0.0, seed=0):
    """Launch the dq kernel. Returns dq in q's dtype."""
    B, H, Sq, Sk, D = _check_qkv(q, k, v, "flash_bwd_dq_cuda")
    _check_grad_side(q, g, lse, delta)
    rows, extra, suffix = _variant(q, Sk, mask, dropout_p, seed)
    code = _kernels.dtype_code(q.dtype)
    dq = torch.empty_like(q)
    lib = _kernels.load_library()
    rc = lib.pdtt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, Sq, Sk, D,
        float(scale), int(bool(causal)),
        *extra, code,
        _kernels.current_stream_handle(q.device))
    name = _kernels.fp16_name("flash_bwd_dq" + suffix, q.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale, mask=None,
                       dropout_p=0.0, seed=0):
    """Launch the dk/dv kernel. Returns (dk, dv) in k's dtype."""
    B, H, Sq, Sk, D = _check_qkv(q, k, v, "flash_bwd_dkv_cuda")
    _check_grad_side(q, g, lse, delta)
    rows, extra, suffix = _variant(q, Sk, mask, dropout_p, seed)
    code = _kernels.dtype_code(q.dtype)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.load_library()
    rc = lib.pdtt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, Sq, Sk, D, float(scale), int(bool(causal)),
        *extra, code,
        _kernels.current_stream_handle(q.device))
    name = _kernels.fp16_name("flash_bwd_dkv" + suffix, q.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    return dk, dv


def dropout_keep_mask_cuda(seed, B, H, Sq, Sk, p, device=None):
    """The keep-mask as the kernels draw it, written out by a small kernel
    that calls `csrc/philox.cuh` (for tests against dropout_keep_mask;
    no launch is counted). bool [B, H, Sq, Sk] on the card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.empty((B, H, Sq, Sk), dtype=torch.bool, device=device)
    lib = _kernels.load_library()
    rc = lib.pdtt_dropout_keep_mask(
        out.data_ptr(), B * H, Sq, Sk, int(seed) & ((1 << 64) - 1),
        float(p), _kernels.current_stream_handle(device))
    _kernels.check_launch(rc, "dropout_keep_mask")
    return out


def flash_attention_delta(g, out):
    """delta = rowsum(g * out) in fp32 [B, H, Sq]: computed outside the
    kernels, as the JAX package does."""
    return (g.float() * out.float()).sum(dim=-1)


def _keep(q, k, dropout_p, seed):
    if dropout_p <= 0.0:
        return None
    B, H, Sq, _ = q.shape
    return dropout_keep_mask(seed, B, H, Sq, k.shape[2], dropout_p,
                             q.device)


def flash_fwd(q, k, v, causal, scale, mask=None, dropout_p=0.0, seed=0):
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal, scale, mask, dropout_p, seed)
    return flash_fwd_plain(q, k, v, causal, scale, mask,
                           _keep(q, k, dropout_p, seed), dropout_p)


def flash_bwd(q, k, v, out, lse, g, causal, scale, mask=None,
              dropout_p=0.0, seed=0):
    """(dq, dk, dv): the two backward kernels on CUDA, the plain version
    on the CPU."""
    delta = flash_attention_delta(g, out)
    if q.is_cuda:
        dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, mask,
                               dropout_p, seed)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale,
                                    mask, dropout_p, seed)
        return dq, dk, dv
    return flash_bwd_plain(q, k, v, g, lse, delta, causal, scale, mask,
                           _keep(q, k, dropout_p, seed), dropout_p)


class FlashAttentionFn(torch.autograd.Function):
    """out = attention(q, k, v, mask) by the forward kernel, saving out
    and lse; the gradient by the dq and dk/dv kernels (the JAX package's
    _flash_vjp_fwd / _flash_vjp_bwd), and the mask's by `_mask_grad` when
    the mask requires it. On CUDA the mask is converted to the kernels'
    fp32 layout once (`_kernel_mask`) and saved for the backward, so the
    three launches share one copy. Dropout regenerates its keep-mask from
    `seed` in every kernel, so nothing of it is stored."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, dropout_p=0.0, seed=0):
        kmask = mask
        if mask is not None and q.is_cuda:
            B, H, Sq, _ = q.shape
            kmask = _kernel_mask(mask, B, H, Sq, k.shape[2])
        out, lse = flash_fwd(q, k, v, causal, scale, kmask, dropout_p, seed)
        ctx.save_for_backward(q, k, v, mask, kmask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout_p, ctx.seed = dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, kmask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g, ctx.causal, ctx.scale,
                               kmask, ctx.dropout_p, ctx.seed)
        dmask = None
        if mask is not None and ctx.needs_input_grad[3]:
            dmask = _mask_grad(q, k, v, mask, lse, g,
                               flash_attention_delta(g, out), ctx.causal,
                               ctx.scale, _keep(q, k, ctx.dropout_p,
                                                ctx.seed), ctx.dropout_p)
        return dq, dk, dv, dmask, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, scale=None, mask=None,
                    dropout_p: float = 0.0, dropout_seed: int = 0):
    """q: [B, H, Sq, D], k/v: [B, H, Sk, D]. Returns [B, H, Sq, D] in q's
    dtype. Causal masking is bottom-right aligned when Sq != Sk; a row
    with no visible key outputs 0. Differentiable, in an additive `mask`
    ([B|1, 1|H, Sq, Sk] or [B, Sq, Sk]) too.

    CUDA tensors go through the forward, dq and dk/dv kernels (D a
    multiple of 16 up to 128, fp32, bf16 or fp16, any sequence lengths),
    with the mask or in-kernel dropout (keyed by `dropout_seed`, see
    dropout_keep_mask) as variants of those kernels; CPU tensors through
    their plain versions. A mask and dropout together take the plain
    reference on either device, by the JAX package's rule (its in-kernel
    keep-mask has no mask gradient), with the same Philox keep-mask."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if mask is not None and dropout_p > 0.0:
        return _attention_reference(q, k, v, causal, scale, mask, dropout_p,
                                    _keep(q, k, dropout_p, dropout_seed))
    q, k, v = (t.contiguous() for t in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, mask, causal, scale,
                                  float(dropout_p), int(dropout_seed))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """paddle.nn.functional.scaled_dot_product_attention: tensors are
    [B, S, H, D] (Paddle's layout); `attn_mask` an additive mask as
    flash_attention takes it. With `training` and dropout_p > 0 each call
    draws a fresh seed from `core.random.next_seed()`, as the JAX package
    draws a key from `next_key()`."""
    from ..core.random import next_seed
    pd = dropout_p if training else 0.0
    seed = next_seed() if pd > 0 else 0
    out = flash_attention(query.transpose(1, 2), key.transpose(1, 2),
                          value.transpose(1, 2), causal=is_causal,
                          mask=attn_mask, dropout_p=pd, dropout_seed=seed)
    return out.transpose(1, 2)


# the KV write guard of the calling thread (kv_write_guard)
_KV_GUARD = threading.local()


@contextlib.contextmanager
def kv_write_guard(guard):
    """For the block's duration, every `update_kv_cache` call on this
    thread enters `guard` (a context manager) around the enqueue of its
    write. The serving engine passes each supervised step attempt's write
    token, which refuses the writes of an attempt it has revoked."""
    prev = getattr(_KV_GUARD, "guard", None)
    _KV_GUARD.guard = guard
    try:
        yield
    finally:
        _KV_GUARD.guard = prev


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write k/v [B, Hkv, T, D] into static [B, Hkv, L, D] caches at `pos`,
    IN PLACE (the JAX package returns new slabs; here the slabs are
    mutated and also returned, so callers read the same either way).

    `pos` is the absolute position of the first new token: an int writes
    every row at one offset, a [B] tensor each row at its own. The start
    is clamped to [0, L - T] exactly as `lax.dynamic_update_slice` clamps
    it, so a write that would overrun the cache lands in the same columns
    as on the JAX side. Under `kv_write_guard` the write is enqueued
    inside the guard.
    """
    guard = getattr(_KV_GUARD, "guard", None)
    if guard is None:
        return _write_kv(k_cache, v_cache, k_new, v_new, pos)
    with guard:
        return _write_kv(k_cache, v_cache, k_new, v_new, pos)


def _write_kv(k_cache, v_cache, k_new, v_new, pos):
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
