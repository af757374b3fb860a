"""Llama-2 model family (counterpart of paddle_tpu/models/llama.py): RMSNorm,
rotary positions (RoPE), a SwiGLU MLP and grouped-query attention (GQA),
with no biases.

Like GPT it has two paths: the cached decode — `init_cache`,
`forward_with_cache` and `generate` — which serving runs, through
`update_kv_cache` and the paged-attention kernel over caches of
`num_key_value_heads` heads; and the no-cache `forward(input_ids,
labels=None)` of training, through the flash-attention kernels with each
kv head repeated for its group of query heads (`repeat_interleave`, as
`jnp.repeat` does), and with labels the mean of `ParallelCrossEntropy`
over the full logits, as the JAX model computes its loss. RMSNorm, RoPE
and SwiGLU are plain torch, as they are plain jax.numpy there: this
family launches no LayerNorm kernel. The cached decode takes
`adapters=` (the per-row LoRA operand, `ops/lora.py`) on all seven
projections, as the JAX model does; the pipeline protocol waits for its
slice and raises.

Parameter names match the JAX package's `functional_state()` keys
(`llama.layers.0.self_attn.q_proj.weight`, ...), and `Linear` weights keep
Paddle's `[in, out]` layout, so `bridge.load_jax_state` copies a JAX
model's arrays in with an identity map.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..distributed.fleet.utils.recompute import recompute
from ..distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                   ParallelCrossEntropy,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding)
from ..nn.layer.layers import Layer, LayerList, create_parameter, \
    init_parameters
from ..ops.attention import (decode_attention, flash_attention,
                             update_kv_cache)
from ..ops.lora import add_lora_delta


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_recompute: bool = False
    # kept so the presets equal the JAX package's; neither package reads
    # it (here the weights take the model's `dtype` argument)
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


LLAMA_PRESETS = {
    "llama2-tiny": LlamaConfig(vocab_size=512, hidden_size=128,
                               intermediate_size=352, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=4,
                               max_position_embeddings=512),
    "llama2-7b": LlamaConfig(),
    "llama2-13b": LlamaConfig(hidden_size=5120, intermediate_size=13824,
                              num_hidden_layers=40, num_attention_heads=40,
                              num_key_value_heads=40),
    "llama2-70b": LlamaConfig(hidden_size=8192, intermediate_size=28672,
                              num_hidden_layers=80, num_attention_heads=64,
                              num_key_value_heads=8),
}

_PIPELINE = ("the pipeline-parallel protocol waits for the multi-GPU slice "
             "(ROADMAP §1 item 8)")


class RMSNorm(Layer):
    """x / sqrt(mean(x^2) + eps) * weight, in fp32, cast back to x's
    dtype."""

    def __init__(self, hidden_size, eps=1e-5, device=None, dtype=None):
        super().__init__()
        self.weight = create_parameter([hidden_size], device, dtype)
        self.eps = eps

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + self.eps)
        return (h * self.weight.float()).to(x.dtype)


def _rope_cos_sin(seq_len, head_dim, theta):
    """fp32 cos and sin tables [seq_len, head_dim] of positions
    0..seq_len-1, each frequency twice (the two halves rotate together)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32)
                                / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], -1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(x, cos, sin):
    """x [B, H, S, D] rotated by cos/sin [S, D] (shared positions) or
    [B, S, D] (a position a row), in x's dtype."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], -1)
    if cos.ndim == 3:
        cos, sin = cos[:, None], sin[:, None]
    return x * cos + rotated * sin


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        h, hd = config.hidden_size, config.head_dim
        kw = dict(has_bias=False, device=device, dtype=dtype)
        self.q_proj = ColumnParallelLinear(h, self.num_heads * hd,
                                           gather_output=False, **kw)
        self.k_proj = ColumnParallelLinear(h, self.num_kv_heads * hd,
                                           gather_output=False, **kw)
        self.v_proj = ColumnParallelLinear(h, self.num_kv_heads * hd,
                                           gather_output=False, **kw)
        self.o_proj = RowParallelLinear(self.num_heads * hd, h,
                                        input_is_parallel=True, **kw)

    def forward(self, hidden, rope, attn_mask=None, cache=None, pos=None,
                paged=None, adapters=None):
        """`rope`: this call's (cos, sin) rows (`_RopeTables`). Without
        `cache`: causal self-attention over the whole sequence through
        flash attention; returns out. With `cache` (k, v [B, Hkv, L, D]):
        writes this call's rotated K/V into it in place at `pos` and
        attends over it; returns (out, (k_cache, v_cache)); `adapters`
        (this layer's ({site: (A, B)}, idx, scale)) adds the gathered LoRA
        delta to q, k, v (before RoPE) and o."""
        if attn_mask is not None:
            raise NotImplementedError(
                "padding masks are not wired into the fused attention yet; "
                "pack sequences or pad-to-multiple instead")
        B, T = hidden.shape[0], hidden.shape[1]
        hd = self.head_dim
        q, k, v = self.q_proj(hidden), self.k_proj(hidden), \
            self.v_proj(hidden)
        if cache is not None and adapters is not None:
            amap, aidx, ascale = adapters
            q = add_lora_delta(q, hidden, amap.get("q_proj"), aidx, ascale)
            k = add_lora_delta(k, hidden, amap.get("k_proj"), aidx, ascale)
            v = add_lora_delta(v, hidden, amap.get("v_proj"), aidx, ascale)
        qh, kh, vh = (t.reshape(B, T, -1, hd).transpose(1, 2)
                      for t in (q, k, v))
        qh, kh = _apply_rope(qh, *rope), _apply_rope(kh, *rope)
        if cache is None:
            n_rep = self.num_heads // self.num_kv_heads
            if n_rep > 1:      # GQA: each kv head serves n_rep query heads
                kh = kh.repeat_interleave(n_rep, dim=1)
                vh = vh.repeat_interleave(n_rep, dim=1)
            out = flash_attention(qh, kh, vh, causal=True)
            return self.o_proj(out.transpose(1, 2).reshape(B, T, -1))
        kc, vc = update_kv_cache(cache[0], cache[1], kh, vh, pos)
        out = decode_attention(qh, kc, vc, pos, scale=1.0 / (hd ** 0.5),
                               paged=paged)
        ctx = out.transpose(1, 2).reshape(B, T, -1)
        out = self.o_proj(ctx)
        if adapters is not None:
            out = add_lora_delta(out, ctx, amap.get("o_proj"), aidx, ascale)
        return out, (kc, vc)


class LlamaMLP(Layer):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(has_bias=False, device=device, dtype=dtype)
        self.gate_proj = ColumnParallelLinear(h, i, gather_output=False,
                                              **kw)
        self.up_proj = ColumnParallelLinear(h, i, gather_output=False, **kw)
        self.down_proj = RowParallelLinear(i, h, input_is_parallel=True,
                                           **kw)

    def forward(self, x, adapters=None):
        gate, up = self.gate_proj(x), self.up_proj(x)
        if adapters is None:
            return self.down_proj(F.silu(gate) * up)
        amap, aidx, ascale = adapters
        gate = add_lora_delta(gate, x, amap.get("gate_proj"), aidx, ascale)
        up = add_lora_delta(up, x, amap.get("up_proj"), aidx, ascale)
        act = F.silu(gate) * up
        return add_lora_delta(self.down_proj(act), act,
                              amap.get("down_proj"), aidx, ascale)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.rms_norm_eps
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = RMSNorm(h, eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(h, eps, device, dtype)
        self._use_recompute = config.use_recompute

    def _block(self, x, cos, sin):
        """The training block: x + attn(norm(x)), then x + MLP(norm(x))."""
        x = x + self.self_attn(self.input_layernorm(x), (cos, sin))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, rope, cache=None, pos=None, paged=None,
                adapters=None):
        """x without a cache (activations recomputed in the backward in
        training with `use_recompute`); (x, new_cache) with one. `rope`:
        the call's (cos, sin) rows; `adapters`: this layer's LoRA operand
        on the cached path."""
        if cache is None:
            if self._use_recompute and self.training:
                return recompute(self._block, x, *rope)
            return self._block(x, *rope)
        h, new_cache = self.self_attn(self.input_layernorm(x), rope,
                                      cache=cache, pos=pos, paged=paged,
                                      adapters=adapters)
        x = x + h
        return (x + self.mlp(self.post_attention_layernorm(x),
                             adapters=adapters), new_cache)


class _RopeTables:
    """The fp32 cos/sin tables of one model, built once a device on the
    CPU (so every device holds the same values) and kept; a longer cache
    than the table rebuilds it at that length. A forward takes its rows
    once and hands them to every layer."""

    def __init__(self, config: LlamaConfig):
        self.head_dim = config.head_dim
        self.theta = config.rope_theta
        self.min_len = config.max_position_embeddings
        self._tables = {}

    def table(self, device, length):
        tab = self._tables.get(device)
        if tab is None or tab[0].shape[0] < length:
            cos, sin = _rope_cos_sin(max(length, self.min_len),
                                     self.head_dim, self.theta)
            tab = self._tables[device] = (cos.to(device), sin.to(device))
        return tab

    def __call__(self, x, L, T, pos):
        """cos/sin in x's dtype for T new tokens: rows 0..T-1 without a
        position, [T, D] from an int `pos`, [B, T, D] from a [B] `pos`;
        each start clamped to [0, L - T] as update_kv_cache clamps its
        write into a cache of L columns."""
        cos, sin = self.table(x.device, L)
        if pos is None:
            rows = slice(0, T)
        elif torch.is_tensor(pos) and pos.ndim == 1:
            start = pos.to(device=x.device, dtype=torch.long).clamp(0, L - T)
            rows = start[:, None] + torch.arange(T, device=x.device)
        else:
            start = min(max(int(pos), 0), L - T)
            rows = slice(start, start + T)
        return cos[rows].to(x.dtype), sin[rows].to(x.dtype)


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self._rope = _RopeTables(config)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device=device,
            dtype=dtype)
        self.layers = LayerList([
            LlamaDecoderLayer(config, device, dtype)
            for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device,
                            dtype)

    def forward(self, input_ids, caches=None, pos=None, paged=None,
                adapters=None):
        """Without `caches`: the final hidden states. With them: (hidden,
        caches) with positions offset by `pos` (an int offsets the whole
        batch, a [B] tensor each row), and `adapters` = (per-layer banks,
        adapter_idx [B], scale [K]) the per-row LoRA operand."""
        hidden = self.embed_tokens(input_ids)
        T = input_ids.shape[1]
        L = T if caches is None else caches[0][0].shape[2]
        rope = self._rope(hidden, L, T, pos)
        if caches is None:
            for layer in self.layers:
                hidden = layer(hidden, rope)
            return self.norm(hidden)
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            layer_ad = None if adapters is None else (
                adapters[0][i], adapters[1], adapters[2])
            hidden, nc = layer(hidden, rope, cache, pos, paged=paged,
                               adapters=layer_ad)
            new_caches.append(nc)
        return self.norm(hidden), new_caches


class LlamaForCausalLM(Layer):
    """Llama with an unbiased lm head. `device` defaults to CUDA (raises
    without a GPU; pass device="cpu" for the plain path); `dtype` to
    float32; weights are drawn from `generator` (a torch.Generator on
    `device`, seeded 0 when None); the RMSNorm weights start at 1."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or torch.float32
        self.config = config
        self.llama = LlamaModel(config, device=device, dtype=dtype)
        self.lm_head = ColumnParallelLinear(config.hidden_size,
                                            config.vocab_size,
                                            has_bias=False,
                                            gather_output=False,
                                            device=device, dtype=dtype)
        self.loss_fn = ParallelCrossEntropy()
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        init_parameters(self, generator)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    def forward(self, input_ids, labels=None):
        """No-cache forward. With `labels` [B, S]: the mean over all B*S
        tokens of ParallelCrossEntropy's fp32 per-token loss over the full
        logits (ignore_index -100 tokens count as 0), an fp32 scalar.
        Without: logits [B, S, V]."""
        logits = self.lm_head(self.llama(input_ids))
        if labels is not None:
            return self.loss_fn(logits, labels).mean()
        return logits

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        """One (k, v) pair a layer, each [batch_size, num_key_value_heads,
        max_len, head_dim] zeros. RoPE has no table end, so any max_len
        is accepted."""
        cfg = self.config
        dt = convert_dtype(dtype) or self.dtype
        shape = (batch_size, cfg.num_key_value_heads, max_len, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def forward_with_cache(self, input_ids, caches, pos, paged=None,
                           adapters=None):
        """(logits [B, S, V], caches). The caches are written in place and
        returned. `paged=(block_table, seq_lens, block_len, pages_per_row)`
        routes attention through slot-pool pages (the serving step);
        `adapters=(per_layer_banks, adapter_idx [B], scale [K])` adds each
        row's gathered LoRA delta (`AdapterBank.device_args()`)."""
        hidden, new_caches = self.llama(input_ids, caches, pos, paged=paged,
                                        adapters=adapters)
        return self.lm_head(hidden), new_caches

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, eos_token_id=None, seed=0,
                 top_p=1.0):
        from .generation import generate
        # keywords: the JAX method passes these positionally into the wrong
        # parameters of generation.generate (ROADMAP §3)
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        do_sample=do_sample, temperature=temperature,
                        top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
                        seed=seed)

    # ---- the pipeline-parallel segmentation protocol of the JAX model ----
    def _pipeline(self, *args, **kwargs):
        raise NotImplementedError(_PIPELINE)

    pipe_layer_prefixes = pipe_layers = pipe_embed = pipe_logits = \
        pipe_head = _pipeline

    @classmethod
    def from_preset(cls, name: str, device=None, dtype=None,
                    generator: Optional[torch.Generator] = None,
                    **overrides):
        cfg = dataclasses.replace(LLAMA_PRESETS[name], **overrides)
        return cls(cfg, device=device, dtype=dtype, generator=generator)
