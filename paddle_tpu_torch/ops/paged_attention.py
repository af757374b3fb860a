"""Ragged paged attention (counterpart of paddle_tpu/ops/paged_attention.py).

One attention primitive for every cached-decode query shape: each batch
row attends over the KV blocks its block table names, masked to its own
ragged length, so one launch serves mixed prefill-chunk rows and decode
rows at once.

Layout contract — shared with `SlotPagedKVPool`, unchanged from the JAX
package:

    k_cache/v_cache  [N, Hkv, L_slab, D]   static slabs, one row per slot
    pages            the first pages_per_row*block_len columns of each row,
                     cut into `block_len`-wide pages; page id
                     g = row * pages_per_row + col_page
    block_table      [B, max_blocks] int32: logical block j of batch row b
                     lives in page table[b, j] (-1 pads; padded entries are
                     clamped to page 0 and must lie past seq_lens[b])
    seq_lens         [B] int32: KV columns >= seq_lens[b] are masked
    q_pos            [B] int32: absolute position of q's first token in
                     row b; causal mask is col <= q_pos[b] + t

Two implementations with the same per-block online-softmax op sequence
(masked scores at _NEG_INF, p an exact 0.0 where s <= _NEG_INF/2, one
alpha rescale per logical block, a final divide by max(l, 1e-30)):

- `paged_attention_plain` — the JAX `_scan_impl` as a Python loop over
  logical blocks; the CPU path and the reference the kernel is held to;
- `paged_attention_cuda` — the hand-written kernels that replace the TPU
  `_paged_kernel`: bf16 and fp16 at a block_len that is a multiple of 8
  run on the tensor cores (`csrc/paged_attention_tc.cu`), everything else
  on the scalar kernel (`csrc/paged_attention.cu`); `paged_route` names
  the one a call takes. An fp16 launch counts as paged_attention_fp16.

Neither materialises the JAX wrapper's `_as_pages` transpose: both
address page g at slab row g // pages_per_row, column
(g % pages_per_row) * block_len. A fully masked block leaves (m, l, acc)
bit-unchanged, so at a fixed block_len a query's output depends only on
its absolute position and the committed KV — chunked prefill equals
whole-prompt prefill bit for bit.
"""
from __future__ import annotations

import torch

from . import _kernels

_NEG_INF = -1e30

# The kv block size the trivial (non-paged) decode path uses. Engine pools
# that want streams identical to one-shot generate() use the same
# block_len (the accumulation grouping, and so the bits, depend on it).
DEFAULT_KV_BLOCK = 8

HEAD_DIMS = (64, 128)
MAX_BLOCK_LEN = 64
TENSOR_CORES, SCALAR = "tensor_cores", "scalar"


def paged_route(dtype, block_len: int, head_dim: int) -> str:
    """The kernel a CUDA call takes: the rule that `pdtt_paged_attention`
    (csrc/paged_attention.cu) applies, mirrored. bf16 and fp16 at a
    block_len that is a multiple of 8 and a head dim of 64 or 128 run on
    the tensor cores; fp32, and bf16 and fp16 at other block lengths, on
    the scalar kernel."""
    if (dtype in (torch.bfloat16, torch.float16) and block_len % 8 == 0
            and head_dim in HEAD_DIMS):
        return TENSOR_CORES
    return SCALAR


def _gather_block(cache, idx, block_len, pages_per_row):
    """[B, Hkv, block_len, D] view-free gather of page idx[b] from the slab."""
    rows = idx // pages_per_row
    cols = ((idx % pages_per_row) * block_len)[:, None] + torch.arange(
        block_len, device=cache.device)
    return cache[rows[:, None], :, cols].permute(0, 2, 1, 3)


def paged_attention_plain(q, k_cache, v_cache, block_table, seq_lens, q_pos,
                          block_len: int, pages_per_row: int, scale: float):
    """The JAX `_scan_impl` in PyTorch: a loop over logical blocks carrying
    (m, l, acc) in fp32, in table order."""
    B, H, Tq, D = q.shape
    Hkv = k_cache.shape[1]
    n_rep = H // Hkv
    dev = q.device
    row = q_pos.long()[:, None] + torch.arange(Tq, device=dev)     # [B, Tq]
    lens = seq_lens.long()
    m = torch.full((B, H, Tq, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    qf = q.float()
    ar = torch.arange(block_len, device=dev)
    table = block_table.long()
    for j in range(table.shape[1]):
        idx = table[:, j].clamp_min(0)      # -1 padding clamps to page 0
        k_j = _gather_block(k_cache, idx, block_len, pages_per_row)
        v_j = _gather_block(v_cache, idx, block_len, pages_per_row)
        if n_rep > 1:
            k_j = k_j.repeat_interleave(n_rep, dim=1)
            v_j = v_j.repeat_interleave(n_rep, dim=1)
        s = (qf @ k_j.float().transpose(-1, -2)) * scale        # [B,H,Tq,KB]
        col = j * block_len + ar
        keep = ((col[None, None, :] <= row[:, :, None])
                & (col[None, None, :] < lens[:, None, None]))
        s = torch.where(keep[:, None], s, torch.full_like(s, _NEG_INF))
        m_cur = s.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        p = torch.where(s <= _NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v_j.dtype).float() @ v_j.float()
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def paged_attention_cuda(q, k_cache, v_cache, block_table, seq_lens, q_pos,
                         block_len: int, pages_per_row: int, scale: float):
    """Launch the CUDA kernel `paged_route` names. q [B,H,Tq,D] and the
    slabs [N,Hkv,L,D] share one dtype (float32, bfloat16 or float16), D in
    (64, 128), Hkv | H; block_table [B, nb], seq_lens and q_pos [B] are
    int32;
    everything contiguous on one GPU, and on the tensor-core route q and
    the slabs start on 16 bytes. Returns a new [B,H,Tq,D] tensor."""
    tensors = (q, k_cache, v_cache, block_table, seq_lens, q_pos)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_attention_cuda takes CUDA tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all paged-attention inputs must be on one device")
    if q.ndim != 4 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"q must be [B,H,Tq,D] and k/v [N,Hkv,L,D], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, Tq, D = q.shape
    N, Hkv, L, Dk = k_cache.shape
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} and match "
                         f"the cache, got q {D} / cache {Dk}")
    if H % Hkv:
        raise ValueError(f"kv heads {Hkv} must divide query heads {H}")
    if not 1 <= block_len <= MAX_BLOCK_LEN:
        raise ValueError(f"block_len must be in 1..{MAX_BLOCK_LEN}, got "
                         f"{block_len}")
    if L < pages_per_row * block_len:
        raise ValueError(f"cache length {L} cannot back {pages_per_row} "
                         f"pages of {block_len} tokens")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q and the caches must share one dtype, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32 \
            or q_pos.dtype != torch.int32:
        raise TypeError("block_table, seq_lens and q_pos must be int32")
    if block_table.ndim != 2 or block_table.shape[0] != B \
            or seq_lens.shape != (B,) or q_pos.shape != (B,):
        raise ValueError(f"block_table must be [{B}, nb] and seq_lens/q_pos "
                         f"[{B}], got {tuple(block_table.shape)}, "
                         f"{tuple(seq_lens.shape)}, {tuple(q_pos.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged-attention kernel takes contiguous tensors")
    if B == 0 or Tq == 0 or block_table.shape[1] == 0:
        raise ValueError("paged-attention kernel needs B, Tq and the block "
                         "table width >= 1")
    code = _kernels.dtype_code(q.dtype)
    lib = _kernels.load_library()
    # the library's own rule names the kernel it launches; its mirror here
    # must agree
    route = (TENSOR_CORES if lib.pdtt_paged_attention_route(
        code, int(block_len), D) else SCALAR)
    if route != paged_route(q.dtype, block_len, D):
        raise RuntimeError(f"pdtt_paged_attention takes the {route} route "
                           f"where paged_route names another")
    if route == TENSOR_CORES and any(
            t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("the tensor-core paged-attention kernel takes q "
                         "and caches whose data starts on a 16-byte "
                         "boundary")
    out = torch.empty_like(q)
    rc = lib.pdtt_paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, H, Tq, D, Hkv, L, block_table.shape[1],
        int(block_len), int(pages_per_row), float(scale), code,
        _kernels.current_stream_handle(q.device))
    name = _kernels.fp16_name("paged_attention", q.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    _kernels.ROUTE_LAUNCHES[f"{name}:{route}"] += 1
    return out


def ragged_paged_attention(q, k_cache, v_cache, block_table, seq_lens,
                           q_pos, *, block_len: int,
                           pages_per_row: int = None, scale: float = None):
    """Attention of q [B, H, Tq, D] over block-table-addressed KV pages.

    k_cache/v_cache: [N, Hkv, L_slab, D] slabs (N need not equal B — block
    tables address pages globally). block_table [B, max_blocks], seq_lens
    [B], q_pos [B] — see the module docstring for the mask contract.
    pages_per_row defaults to L_slab // block_len (pass the pool's
    n_blocks when the slab carries chunk write-padding). A CUDA q launches
    the kernel; a CPU q takes the plain version.
    """
    B, H, Tq, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if pages_per_row is None:
        pages_per_row = k_cache.shape[2] // block_len
    if k_cache.shape[2] < pages_per_row * block_len:
        raise ValueError(
            f"cache length {k_cache.shape[2]} cannot back {pages_per_row} "
            f"pages of {block_len} tokens")
    dev = q.device
    block_table = torch.as_tensor(block_table, dtype=torch.int32, device=dev)
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=dev)
    if q.is_cuda:
        return paged_attention_cuda(
            q.contiguous(), k_cache, v_cache, block_table.contiguous(),
            seq_lens.contiguous(), q_pos.contiguous(), block_len,
            pages_per_row, scale)
    return paged_attention_plain(q, k_cache, v_cache, block_table, seq_lens,
                                 q_pos, block_len, pages_per_row, scale)


def trivial_block_table(batch: int, cache_len: int,
                        block_len: int = DEFAULT_KV_BLOCK, device=None):
    """Identity table for a contiguous per-row cache: logical block j of
    row b is page b*nb + j. Returns (table [B, nb] int32, nb); callers pad
    the cache to nb*block_len columns (padded cols are masked by
    seq_lens)."""
    nb = -(-cache_len // block_len)
    table = (torch.arange(batch, dtype=torch.int32, device=device)[:, None]
             * nb + torch.arange(nb, dtype=torch.int32, device=device)[None])
    return table, nb
