"""Autoregressive generation with a static KV cache (counterpart of
paddle_tpu/models/generation.py).

One prefill call fills the cache for the prompt, then one decode step per
token writes at the row's position; the loop stops as soon as every row
has emitted EOS. `make_decoder_fns` exposes the prefill and decode-step
builders so the serving engine and `generate()` share one cache layout
and one numeric path (the ragged paged-attention kernel at
DEFAULT_KV_BLOCK); `make_verify_fn` is the prefill with a greedy token at
every position, speculative decoding's verify.

Selection is greedy, or with `do_sample=True` a temperature / top-k /
top-p draw on JAX's own threefry stream (`core.threefry`), so a seeded
stream equals the JAX package's token for token. PyTorch runs eagerly,
so there is no jit cache here; the caches are written in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import threefry
from ..ops.paged_attention import DEFAULT_KV_BLOCK

_NEG = -1e30     # a filtered-out logit, as the JAX package writes it


def make_decoder_fns(model):
    """Return (params, prefill, decode_step) over raw tensors:

      prefill(params, prompt [B, S], caches, pos, paged=None,
              adapters=None) -> (logits [B, S, V], caches)
      decode_step(params, tok [B], pos, caches, paged=None,
                  adapters=None) -> (logits [B, V], caches)

    `pos` is an int (whole batch at one offset) or a [B] int tensor
    (per-row offsets, the slot-paged serving engine). `caches` is
    `model.init_cache()` layout and is written in place. `adapters` is an
    `AdapterBank` operand (each row gathers its own LoRA delta; None: the
    base model). `params` is the model's named-parameter dict, kept for
    signature parity with the JAX builders; the functions read the
    model's own parameters."""
    params = dict(model.named_parameters())

    def prefill(p, prompt, caches_, pos, paged=None, adapters=None):
        return model.forward_with_cache(prompt, caches_, pos, paged=paged,
                                        adapters=adapters)

    def decode_step(p, tok, pos, caches_, paged=None, adapters=None):
        logits, caches_ = model.forward_with_cache(
            tok[:, None], caches_, pos, paged=paged, adapters=adapters)
        return logits[:, 0], caches_

    return params, prefill, decode_step


def make_verify_fn(model):
    """Multi-position greedy verify builder for speculative decoding:
    returns (params, verify) with

      verify(params, toks [B, C], caches, pos, paged=None,
             adapters=None) -> (tokens [B, C] int32, caches)

    the prefill forward with a greedy selection at EVERY position:
    tokens[b, t] is the token the model emits after consuming
    toks[b, :t+1] on top of the cache at `pos`. Each position's logits
    see the causal mask a sequential decode would, so for a verify row
    [last_tok, d1..dK] tokens[b, t] is what t+1 decode steps give, and
    the longest matching draft prefix plus the first divergent token is
    the plain greedy stream. Reading column adv-1 alone is the plain
    step."""
    params, prefill, _ = make_decoder_fns(model)

    def verify(p, toks, caches_, pos, paged=None, adapters=None):
        logits, caches_ = prefill(p, toks, caches_, pos, paged=paged,
                                  adapters=adapters)
        return _select_greedy(logits), caches_

    return params, verify


def _select_greedy(logits):
    """Greedy selection on fp32 logits; argmax ties pick the first index,
    as jnp.argmax does."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def _per_row(x, B, dtype, device):
    """A scalar or [B] knob as a [B] tensor on `device`."""
    return torch.as_tensor(x, dtype=dtype, device=device).expand(B)


def _top_p_filter(lg, top_p):
    """Nucleus filter on [B, V] fp32 logits; `top_p` is a scalar or [B].

    Keeps the smallest set of tokens whose probability mass reaches top_p
    (a sorted slot survives while the mass before it is still < p, so the
    most likely token always does), then maps the sorted cut back to
    logit space as a per-row threshold: ties at the threshold survive.
    The reference's formula, op for op: a softmax of the sorted row as
    exp(x - max) / sum, `cumsum(p) - p`, and a `>=` threshold."""
    B = lg.shape[0]
    p = _per_row(top_p, B, torch.float32, lg.device)
    srt = torch.sort(lg, dim=-1, descending=True).values
    e = torch.exp(srt - srt[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    n_keep = (cum_before < p[:, None]).sum(dim=-1).clamp(min=1)
    thr = srt.gather(1, (n_keep - 1)[:, None])
    keep = (lg >= thr) | (p[:, None] >= 1.0)
    return torch.where(keep, lg, _NEG)


def _top_k_filter(lg, top_k):
    """Per-row top-k filter on [B, V] logits; `top_k` is a scalar or [B]
    (the serving engine's batched path), k <= 0 means no filter for that
    row. Sort-based so k can differ per row; every logit >= the kth
    survives, as in the static branch."""
    B, V = lg.shape
    k = _per_row(top_k, B, torch.int64, lg.device)
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = srt.gather(1, (k.clamp(1, V) - 1)[:, None])
    keep = (lg >= kth) | (k[:, None] <= 0)
    return torch.where(keep, lg, _NEG)


def _select_token(logits, do_sample, temperature, top_k, key, top_p=1.0):
    """logits [B, V] -> next token [B] int32 (greedy or temperature /
    top-k / top-p), on the logits' device.

    Two calling conventions, as in the JAX package:

    * static knobs (one-shot generate()): `do_sample` a python bool,
      `temperature`/`top_k`/`top_p` python scalars, `key` one threefry
      key [2] for the whole [B, V] draw; top-k takes the kth value of
      `torch.topk` (lax.top_k's);
    * batched per-row params (the serving engine): `do_sample` a bool
      [B] tensor, `temperature`/`top_k`/`top_p` [B] tensors, `key` a
      [B, 2] tensor of per-row keys; greedy and sampled rows mix freely.
    """
    if isinstance(do_sample, bool):
        if not do_sample:
            return _select_greedy(logits)
        # a tensor divisor: CUDA divides by a CPU scalar as a multiply by
        # its reciprocal, which is not XLA's division
        t = torch.tensor(max(float(temperature), 1e-6), dtype=torch.float32,
                         device=logits.device)
        lg = logits.float() / t
        if top_k and top_k > 0:
            kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
            lg = torch.where(lg < kth, _NEG, lg)
        if top_p is not None and float(top_p) < 1.0:
            lg = _top_p_filter(lg, float(top_p))
        return threefry.categorical(key, lg).to(torch.int32)
    B = logits.shape[0]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = _per_row(temperature, B, torch.float32, logits.device)
    lg = logits.float() / temp.clamp_min(1e-6)[:, None]
    lg = _top_k_filter(lg, top_k)
    lg = _top_p_filter(lg, top_p)
    sampled = threefry.categorical(key, lg).to(torch.int32)
    return torch.where(do_sample.to(torch.bool), sampled, greedy)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=0):
    """Returns a CPU int32 tensor [B, S0 + max_new_tokens] of prompt +
    continuation. With eos_token_id, finished rows pad with eos and the
    decode loop stops early once every row has finished. The number of
    decode steps actually run is recorded on the model as
    `_last_decode_steps` (prefill's token excluded).

    With `do_sample=True` each token is drawn by `_select_token`'s static
    branch on the JAX package's key schedule: key = PRNGKey(seed), then
    `key, sub = split(key)` before the first token and before every
    decode step, one `sub` for the whole [B, V] draw. The keys are a few
    words, kept on the CPU; the draw runs on the logits' device."""
    ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                     else input_ids).astype(np.int32)
    B, S0 = ids.shape
    if max_new_tokens <= 0:
        return torch.from_numpy(ids)
    L = S0 + max_new_tokens
    # round the cache up to whole kv blocks: the extra columns stay zero
    # and are masked, exactly like the JAX decode path's zero padding, and
    # the cache never needs re-padding per step
    L_alloc = -(-L // DEFAULT_KV_BLOCK) * DEFAULT_KV_BLOCK
    if L_alloc > model.config.max_position_embeddings:
        L_alloc = L
    dev = model.device
    caches = model.init_cache(B, L_alloc)
    was_training = model.training
    model.eval()
    _, prefill, decode_step = make_decoder_fns(model)
    key = threefry.prng_key(seed)

    def select(logits):
        nonlocal key
        if not do_sample:
            return _select_greedy(logits)
        key, sub = threefry.split(key)
        return _select_token(logits, True, temperature, top_k, sub.to(dev),
                             top_p)

    prompt = torch.from_numpy(ids).to(dev)
    logits, caches = prefill(None, prompt, caches, 0)
    tok = select(logits[:, -1])
    eos_fill = 0 if eos_token_id is None else int(eos_token_id)
    buf = torch.full((B, max_new_tokens), eos_fill, dtype=torch.int32,
                     device=dev)
    buf[:, 0] = tok
    done = (torch.zeros(B, dtype=torch.bool, device=dev)
            if eos_token_id is None else tok == eos_token_id)
    steps = 0
    for i in range(max_new_tokens - 1):
        if eos_token_id is not None and bool(done.all()):
            break
        step_logits, caches = decode_step(None, tok, S0 + i, caches)
        nxt = select(step_logits)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        buf[:, i + 1] = nxt
        tok = nxt
        steps += 1
    model.__dict__["_last_decode_steps"] = steps
    if was_training:
        model.train()
    return torch.cat([torch.from_numpy(ids), buf.cpu()], dim=1)
