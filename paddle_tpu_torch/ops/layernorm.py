"""Fused LayerNorm forward and backward (counterpart of
paddle_tpu/ops/layernorm.py).

The TPU kernels `_fwd_kernel` and `_bwd_kernel` become the hand-written
CUDA kernels in `csrc/layernorm.cu`. The forward does one pass per row
with fp32 mean and rstd, a fused affine and y cast back to the input
dtype, and returns the statistics beside y. The backward reads them back:
dx in one pass with the JAX kernel's two row means c1 and c2, and dw, db
summed over the rows in fp32 (per-CTA partials and a fixed-order second
pass in place of the TPU's sequential accumulator), cast to w's dtype.

The kernels' launch configuration comes from N and the dtype alone
(`fwd_config`, `bwd_config`, mirrors of the tables in `layernorm.cu`), so
a row's result never depends on how many rows come with it; the pointers'
alignment picks 16-byte or scalar accesses, which give the same bits.

`layer_norm_fwd` and `layer_norm_bwd` take the kernel for a CUDA tensor
and the plain PyTorch version for a CPU tensor; nothing else decides. On
CUDA the kernels always run: the JAX package's FLAGS_use_fused_layernorm
default of "off" rests on a TPU measurement and is not carried over, nor
are its TPU tiling rules (N % 128, row blocks). `fused_layer_norm` is
differentiable on both devices: on CUDA through `LayerNormFn` (forward
kernel, backward kernel), on the CPU by autograd through the plain math.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels

MAX_N = 8192

# The instantiations of csrc/layernorm.cu (PDTT_LN_FWD_*, PDTT_LN_BWD_*),
# smallest first: (threads a row, 16-byte packs a thread) for the forward,
# plus (rows a batch, shared-memory stages) for the backward. A row of N
# values is ceil(N / pack) packs and takes the first entry that covers
# them.
FWD_BUCKETS = {
    torch.float32: ((8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (64, 4),
                    (128, 4), (256, 4), (512, 4)),
    torch.bfloat16: ((8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (128, 2),
                     (128, 4), (256, 4)),
}
BWD_BUCKETS = {
    torch.float32: ((32, 1, 4, 3), (64, 1, 4, 3), (128, 1, 4, 3),
                    (256, 1, 2, 3), (256, 2, 2, 3), (256, 4, 1, 3),
                    (256, 8, 1, 2)),
    torch.bfloat16: ((32, 1, 4, 3), (64, 1, 4, 3), (128, 1, 4, 3),
                     (256, 1, 2, 3), (256, 2, 1, 4), (256, 4, 1, 3)),
}
# fp16 packs 8 values in 16 bytes, as bf16 does: the same entries
FWD_BUCKETS[torch.float16] = FWD_BUCKETS[torch.bfloat16]
BWD_BUCKETS[torch.float16] = BWD_BUCKETS[torch.bfloat16]
_FWD_CTA_THREADS = 128      # a forward CTA, unless one row takes more


class LnConfig(NamedTuple):
    """One launch of a LayerNorm kernel, as csrc/layernorm.cu picks it."""
    threads_per_row: int
    packs_per_thread: int
    width: int          # values an access: a 16-byte pack, or 1 (scalar)
    rows: int           # forward: rows a CTA; backward: rows a batch
    stages: int         # backward: batches staged in shared memory


def pack_of(dtype) -> int:
    """Values of `dtype` in 16 bytes."""
    if dtype not in FWD_BUCKETS:
        raise TypeError(f"the LayerNorm kernels take float32, bfloat16 or "
                        f"float16, got {dtype}")
    return 16 // torch.empty((), dtype=dtype).element_size()


def _bucket(table, N, dtype):
    if not 1 <= N <= MAX_N:
        raise ValueError(f"LayerNorm kernel takes 1 <= N <= {MAX_N}, got {N}")
    packs = -(-N // pack_of(dtype))
    return next(e for e in table[dtype] if e[0] * e[1] >= packs)


def _width(N, dtype, aligned) -> int:
    pack = pack_of(dtype)
    return pack if aligned and N % pack == 0 else 1


def fwd_config(N: int, dtype, aligned: bool) -> LnConfig:
    """The forward's launch for rows of N values of `dtype`; `aligned`:
    every pointer it is given is 16-byte aligned. Nothing here depends on
    the number of rows."""
    tpr, per = _bucket(FWD_BUCKETS, N, dtype)
    return LnConfig(tpr, per, _width(N, dtype, aligned),
                    max(tpr, _FWD_CTA_THREADS) // tpr, 0)


def bwd_config(N: int, dtype, aligned: bool) -> LnConfig:
    """The backward's launch, as `fwd_config` (its grid comes from R)."""
    tpr, per, rows, stages = _bucket(BWD_BUCKETS, N, dtype)
    return LnConfig(tpr, per, _width(N, dtype, aligned), rows, stages)


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def layer_norm_fwd_plain(x2d, w, b, eps):
    """The JAX kernel's arithmetic in PyTorch: (y, mu [R,1], rstd [R,1])."""
    h = x2d.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = (h - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((h - mu) * rstd) * w.float() + b.float()
    return y.to(x2d.dtype), mu, rstd


def layer_norm_fwd_cuda(x2d, w, b, eps):
    """Launch the CUDA kernel: x2d [R, N] contiguous, w/b [N] of x's dtype
    (float32, bfloat16 or float16), N <= 8192. Returns (y, mu [R,1],
    rstd [R,1]). The fp16 instantiation counts as layernorm_fwd_fp16."""
    if not (x2d.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError("layer_norm_fwd_cuda takes CUDA tensors")
    if x2d.ndim != 2:
        raise ValueError(f"x must be [R, N], got {tuple(x2d.shape)}")
    R, N = x2d.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"LayerNorm kernel takes 1 <= N <= {MAX_N}, got {N}")
    if w.shape != (N,) or b.shape != (N,):
        raise ValueError(f"weight/bias must be [{N}], got "
                         f"{tuple(w.shape)}/{tuple(b.shape)}")
    if not (w.dtype == b.dtype == x2d.dtype):
        raise TypeError(f"x, weight and bias must share one dtype, got "
                        f"{x2d.dtype}/{w.dtype}/{b.dtype}")
    if not (x2d.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("LayerNorm kernel takes contiguous tensors")
    if not (x2d.device == w.device == b.device):
        raise ValueError("x, weight and bias must be on one device")
    code = _kernels.dtype_code(x2d.dtype)
    y = torch.empty_like(x2d)
    mu = torch.empty((R, 1), device=x2d.device, dtype=torch.float32)
    rstd = torch.empty((R, 1), device=x2d.device, dtype=torch.float32)
    if R == 0:
        return y, mu, rstd
    lib = _kernels.load_library()
    rc = lib.pdtt_layernorm_fwd(
        x2d.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), R, N, float(eps), code,
        _kernels.current_stream_handle(x2d.device))
    name = _kernels.fp16_name("layernorm_fwd", x2d.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    return y, mu, rstd


def layer_norm_fwd(x2d, w, b, eps):
    if x2d.is_cuda:
        return layer_norm_fwd_cuda(x2d, w, b, eps)
    return layer_norm_fwd_plain(x2d, w, b, eps)


# dw/db partial rows: about two CTAs a streaming multiprocessor (132 on an
# H100 SXM), each over a contiguous run of rows, and at most
# BWD_MAX_ROWS rows a run, so that no fp32 partial sums more rows in one
# sequence than that (past R = 16,896 the runs stop growing and G grows
# instead). Depends on R alone, so the summation order, and the result,
# is the same in every run.
BWD_TARGET_CTAS = 264
BWD_MAX_ROWS = 64


def _bwd_rows_per_cta(R: int) -> int:
    return max(1, min(BWD_MAX_ROWS, -(-R // BWD_TARGET_CTAS)))


def layer_norm_bwd_plain(x2d, w, mu, rstd, dy2d):
    """The JAX backward kernel's arithmetic in PyTorch: (dx in x's dtype,
    dw and db summed in fp32 and cast to w's dtype)."""
    h = x2d.float()
    dy = dy2d.float()
    xhat = (h - mu) * rstd
    a = dy * w.float()
    c1 = (a * xhat).mean(dim=-1, keepdim=True)
    c2 = a.mean(dim=-1, keepdim=True)
    dx = ((a - c2 - xhat * c1) * rstd).to(x2d.dtype)
    dw = (dy * xhat).sum(dim=0)
    db = dy.sum(dim=0)
    return dx, dw.to(w.dtype), db.to(w.dtype)


def layer_norm_bwd_cuda(x2d, w, mu, rstd, dy2d):
    """Launch the backward kernel: x2d, dy2d [R, N] contiguous of w's dtype
    (float32, bfloat16 or float16), mu/rstd [R, 1] fp32 from the forward,
    N <= 8192. Returns (dx, dw, db). The fp16 instantiation counts as
    layernorm_bwd_fp16."""
    tensors = (x2d, w, mu, rstd, dy2d)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("layer_norm_bwd_cuda takes CUDA tensors")
    if x2d.ndim != 2 or dy2d.shape != x2d.shape:
        raise ValueError(f"x and dy must be one [R, N] shape, got "
                         f"{tuple(x2d.shape)}/{tuple(dy2d.shape)}")
    R, N = x2d.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"LayerNorm kernel takes 1 <= N <= {MAX_N}, got {N}")
    if w.shape != (N,) or mu.shape != (R, 1) or rstd.shape != (R, 1):
        raise ValueError(f"weight must be [{N}] and mu/rstd [{R}, 1], got "
                         f"{tuple(w.shape)}/{tuple(mu.shape)}/"
                         f"{tuple(rstd.shape)}")
    if not (w.dtype == dy2d.dtype == x2d.dtype):
        raise TypeError(f"x, dy and weight must share one dtype, got "
                        f"{x2d.dtype}/{dy2d.dtype}/{w.dtype}")
    if mu.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("mu and rstd must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("LayerNorm kernel takes contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all LayerNorm tensors must be on one device")
    code = _kernels.dtype_code(x2d.dtype)
    dx = torch.empty_like(x2d)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    if R == 0:
        return dx, dw.zero_(), db.zero_()
    rows = _bwd_rows_per_cta(R)
    n_cta = -(-R // rows)
    part = torch.empty((2, n_cta, N), device=x2d.device,
                       dtype=torch.float32)
    lib = _kernels.load_library()
    rc = lib.pdtt_layernorm_bwd(
        x2d.data_ptr(), w.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy2d.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), R, N, rows, code,
        _kernels.current_stream_handle(x2d.device))
    name = _kernels.fp16_name("layernorm_bwd", x2d.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    return dx, dw, db


def layer_norm_bwd(x2d, w, mu, rstd, dy2d):
    if x2d.is_cuda:
        return layer_norm_bwd_cuda(x2d, w, mu, rstd, dy2d)
    return layer_norm_bwd_plain(x2d, w, mu, rstd, dy2d)


class LayerNormFn(torch.autograd.Function):
    """y = LN(x2d) * w + b with the forward kernel; its gradient is the
    backward kernel on the saved x, w, mu and rstd (the JAX package's
    custom_vjp pair _fused_vjp_fwd / _fused_vjp_bwd)."""

    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        y, mu, rstd = layer_norm_fwd(x2d, w, b, eps)
        ctx.save_for_backward(x2d, w, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w, mu, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2d, w, mu, rstd, dy.contiguous())
        return dx, dw, db, None


def fused_layer_norm(x, weight, bias, eps=1e-5):
    """x: [..., N]; weight/bias: [N]. LayerNorm over the last axis with fp32
    statistics, output in x's dtype. Differentiable: on CUDA through the
    two kernels, on the CPU by autograd through the plain math."""
    N = x.shape[-1]
    x2d = x.contiguous().reshape(-1, N)
    if x2d.is_cuda:
        y = LayerNormFn.apply(x2d, weight, bias, eps)
    else:
        y, _, _ = layer_norm_fwd_plain(x2d, weight, bias, eps)
    return y.reshape(x.shape)
