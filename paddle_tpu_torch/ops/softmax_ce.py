"""Chunked lm-head + softmax cross-entropy (counterpart of
paddle_tpu/ops/softmax_ce.py).

The [N, V] logits of a causal-LM head are consumed only by the loss, so
they are never materialised: the forward walks vocabulary chunks, takes
each chunk's logits h @ w_c with an fp32 result, and carries a running
(max, sum of exp, target logit) triple in fp32; the backward recomputes
each chunk's logits and contracts d = (softmax - onehot) * g into dh and
dW at once. V is padded to a multiple of the chunk count and the padded
columns are masked to -inf. The products are `torch` matrix products, as
the JAX package leaves them to XLA: there is no TPU kernel here.

The JAX package takes bf16 operands with an fp32 result
(`preferred_element_type`); a bf16 `torch.matmul` would round the result
to bf16 and move a loss of ~10 by ~0.02. On CUDA the chunk's logits come
from `torch.mm(..., out_dtype=torch.float32)` (bf16 in, fp32 out, one
cuBLAS call); on the CPU, and for fp32 operands, from fp32 operands,
which gives the same products (a bf16 x bf16 product is exact in fp32).
As in the JAX backward, d is cast to h's dtype before the dh and dW
products, and dh accumulates in h's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _logits_f32(h, w_c):
    """h @ w_c with an fp32 result from operands of h's dtype."""
    if h.dtype == torch.float32:
        return h @ w_c
    if h.is_cuda:
        return torch.mm(h, w_c, out_dtype=torch.float32)
    return h.float() @ w_c.float()


def _chunks(w, n_chunks):
    """[H, V] -> (n_chunks column blocks of [H, C] over w padded with zero
    columns to n_chunks * C, C)."""
    V = w.shape[1]
    C = -(-V // n_chunks)
    pad = n_chunks * C - V
    wp = F.pad(w, (0, pad)) if pad else w
    return [wp[:, c * C:(c + 1) * C] for c in range(n_chunks)], C


def _masked_chunk_logits(h, w_c, c, C, V):
    lg = _logits_f32(h, w_c)
    cols = c * C + torch.arange(C, device=h.device)[None, :]
    return lg.masked_fill(cols >= V, float("-inf")), cols


class FusedLinearCrossEntropyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, n_chunks):
        N = h.shape[0]
        V = w.shape[1]
        labels = labels.reshape(N).long()
        chunks, C = _chunks(w, n_chunks)
        m = torch.full((N,), float("-inf"), device=h.device)
        s = torch.zeros((N,), device=h.device)
        tl = torch.zeros((N,), device=h.device)
        for c, w_c in enumerate(chunks):
            lg, cols = _masked_chunk_logits(h, w_c, c, C, V)
            m_new = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(dim=-1)
            tl = tl + torch.where(cols == labels[:, None], lg, 0.0).sum(
                dim=-1)
            m = m_new
        lse = m + torch.log(s)
        loss = torch.where(labels == ignore_index, 0.0, lse - tl)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.ignore_index, ctx.n_chunks = ignore_index, n_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        V = w.shape[1]
        gv = torch.where(labels == ctx.ignore_index, 0.0, g.float())
        chunks, C = _chunks(w, ctx.n_chunks)
        dh = torch.zeros_like(h)
        dws = []
        for c, w_c in enumerate(chunks):
            lg, cols = _masked_chunk_logits(h, w_c, c, C, V)
            p = torch.exp(lg - lse[:, None])
            d = (p - (cols == labels[:, None]).float()) * gv[:, None]
            d16 = d.to(h.dtype)
            dh = dh + d16 @ w_c.t()
            dws.append(h.t() @ d16)
        dw = torch.cat(dws, dim=1)[:, :V]
        return dh, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(h, w, labels, ignore_index=-100, n_chunks=8):
    """h: [N, H] (compute dtype); w: [H, V]; labels: [N] int. Returns the
    per-token loss [N] fp32, 0 where labels == ignore_index. Equivalent to
    softmax cross-entropy of h @ w without materialising the [N, V]
    logits; differentiable in h and w."""
    return FusedLinearCrossEntropyFn.apply(h, w, labels, ignore_index,
                                           n_chunks)
