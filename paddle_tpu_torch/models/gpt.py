"""GPT model family (counterpart of paddle_tpu/models/gpt.py): pre-LN GPT
with learned positions and a tanh-GELU MLP.

The model has two paths: the cached decode — `init_cache`,
`forward_with_cache` and `generate` — which serving runs, and the
no-cache `forward(input_ids, labels=None)` of training, through flash
attention and, with labels, the chunked lm-head + cross-entropy (the JAX
package's FLAGS_fused_lm_ce default; FLAGS_fused_lm_ce=0 takes the
logits and `ParallelCrossEntropy`). An MoE config (the `ernie-moe-*`
presets) puts an `MoELayer` in place of the MLP of every
`moe_every_n_layers`-th layer; its aux loss flows out of each block
(through recompute too), and the loss adds their sum times
`moe_aux_loss_weight`. As in the JAX package, the cached decode refuses
an MoE model. The cached decode takes `adapters=` (per-layer LoRA banks,
a bank row a batch row, the rows' scales: `serving/llm/lora.py`), whose
gathered delta (`ops/lora.py`) lands on `qkv_proj` after its bias,
`out_proj`, and `linear1` and `linear2` around the tanh GELU, as in the
JAX model; `tuning.inject_lora` wraps the same four projections for
training.

Parameter names match the JAX package's `functional_state()` keys, and
`Linear` weights keep Paddle's `[in, out]` layout, so `bridge.load_jax_state`
copies a JAX model's arrays in with an identity map.
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
from ..nn import Dropout, Embedding, LayerNorm
from ..nn.layer.layers import Layer, LayerList, init_parameters
from ..nn.layer.moe import MoELayer
from ..ops.attention import (decode_attention, flash_attention,
                             update_kv_cache)
from ..ops.lora import add_lora_delta
from ..ops.softmax_ce import fused_linear_cross_entropy


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-5
    use_recompute: bool = False
    # MoE (ERNIE-MoE-style, BASELINE config 5): 0 = dense
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_every_n_layers: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


GPT_PRESETS = {
    "gpt2-tiny": GPTConfig(vocab_size=512, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=512,
                           max_position_embeddings=512),
    "gpt3-125m": GPTConfig(hidden_size=768, num_hidden_layers=12,
                           num_attention_heads=12, intermediate_size=3072),
    "gpt3-350m": GPTConfig(hidden_size=1024, num_hidden_layers=24,
                           num_attention_heads=16, intermediate_size=4096),
    "gpt3-1.3b": GPTConfig(hidden_size=2048, num_hidden_layers=24,
                           num_attention_heads=16, intermediate_size=8192),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_hidden_layers=32,
                           num_attention_heads=32, intermediate_size=16384),
    "ernie-moe-tiny": GPTConfig(vocab_size=512, hidden_size=128,
                                num_hidden_layers=4, num_attention_heads=4,
                                intermediate_size=256,
                                max_position_embeddings=512,
                                moe_num_experts=4),
    "ernie-moe-base": GPTConfig(hidden_size=768, num_hidden_layers=12,
                                num_attention_heads=12,
                                intermediate_size=3072, moe_num_experts=8),
}

class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, has_bias=True,
                                             gather_output=False,
                                             device=device, dtype=dtype)
        self.out_proj = RowParallelLinear(h, h, has_bias=True,
                                          input_is_parallel=True,
                                          device=device, dtype=dtype)
        self.dropout_p = config.attention_dropout_prob

    def forward(self, hidden, cache=None, pos=None, paged=None,
                adapters=None):
        """Without `cache`: causal self-attention over the whole sequence
        through flash attention; returns out. With `cache`: writes this
        call's K/V into it in place at `pos` and attends over it; returns
        (out, (k_cache, v_cache)); `adapters` (this layer's
        ({site: (A, B)}, idx, scale)) adds the gathered LoRA delta to the
        qkv and out projections. (GPT passes no dropout to attention.)"""
        qkv = self.qkv_proj(hidden)
        if cache is not None and adapters is not None:
            amap, aidx, ascale = adapters
            qkv = add_lora_delta(qkv, hidden, amap.get("qkv_proj"), aidx,
                                 ascale)
        hd = self.head_dim
        B, T = qkv.shape[0], qkv.shape[1]
        n_local = qkv.shape[-1] // (3 * hd)
        q, k, v = qkv.reshape(B, T, n_local, 3 * hd).split(hd, dim=-1)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if cache is None:
            out = flash_attention(qh, kh, vh, causal=True)
            return self.out_proj(out.transpose(1, 2).reshape(B, T, -1))
        kc, vc = update_kv_cache(cache[0], cache[1], kh, vh, pos)
        out = decode_attention(qh, kc, vc, pos, scale=1.0 / (hd ** 0.5),
                               paged=paged)
        ctx = out.transpose(1, 2).reshape(B, T, -1)
        out = self.out_proj(ctx)
        if adapters is not None:
            out = add_lora_delta(out, ctx, amap.get("out_proj"), aidx,
                                 ascale)
        return out, (kc, vc)


class GPTDecoderLayer(Layer):
    def __init__(self, config: GPTConfig, use_moe: bool = False,
                 device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.norm1 = LayerNorm(h, epsilon=config.layer_norm_eps,
                               device=device, dtype=dtype)
        self.self_attn = GPTAttention(config, device=device, dtype=dtype)
        self.norm2 = LayerNorm(h, epsilon=config.layer_norm_eps,
                               device=device, dtype=dtype)
        self.use_moe = use_moe
        if use_moe:
            self.moe = MoELayer(h, config.intermediate_size,
                                config.moe_num_experts, config.moe_top_k,
                                config.moe_capacity_factor, device=device,
                                dtype=dtype)
        else:
            self.linear1 = ColumnParallelLinear(h, config.intermediate_size,
                                                has_bias=True,
                                                gather_output=False,
                                                device=device, dtype=dtype)
            self.linear2 = RowParallelLinear(config.intermediate_size, h,
                                             has_bias=True,
                                             input_is_parallel=True,
                                             device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self._use_recompute = config.use_recompute

    def _block(self, x):
        """The training block: x + attn(LN(x)), then x + MLP(LN(x)) or x +
        MoE(LN(x)). Returns (x, aux): the MoE aux loss leaves through the
        output, so it survives recompute; None for a dense layer."""
        x = x + self.dropout(self.self_attn(self.norm1(x)))
        if self.use_moe:
            h = self.moe(self.norm2(x))
            aux = self.moe.aux_loss
        else:
            h = F.gelu(self.linear1(self.norm2(x)), approximate="tanh")
            h = self.linear2(h)
            aux = None
        return x + self.dropout(h), aux

    def forward(self, x, cache=None, pos=None, paged=None, adapters=None):
        """(x, new_cache) with a cache; (x, aux) without (the JAX layer's
        (x, aux_loss), aux None for a dense layer). In training with
        `use_recompute`, the block's activations are recomputed in the
        backward instead of kept. An MoE layer has no cached decode.
        `adapters`: this layer's LoRA operand on the cached path."""
        if cache is None:
            if self._use_recompute and self.training:
                if self.use_moe:
                    return recompute(self._block, x)
                return recompute(lambda a: self._block(a)[0], x), None
            return self._block(x)
        if self.use_moe:
            raise NotImplementedError(
                "KV-cache decode is not wired through MoE layers yet")
        h, new_cache = self.self_attn(self.norm1(x), cache, pos, paged=paged,
                                      adapters=adapters)
        x = x + self.dropout(h)
        h_in = self.norm2(x)
        h = self.linear1(h_in)
        if adapters is not None:
            amap, aidx, ascale = adapters
            h = add_lora_delta(h, h_in, amap.get("linear1"), aidx, ascale)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
        h2 = self.linear2(h)
        if adapters is not None:
            h2 = add_lora_delta(h2, h, amap.get("linear2"), aidx, ascale)
        x = x + self.dropout(h2)
        return x, new_cache


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device=device,
            dtype=dtype)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layers = LayerList([
            GPTDecoderLayer(config, use_moe=self._is_moe(i), device=device,
                            dtype=dtype)
            for i in range(config.num_hidden_layers)])
        self.final_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)

    def _is_moe(self, i):
        """Layer i is an MoE layer: every moe_every_n_layers-th, counting
        from 1, of an MoE config."""
        cfg = self.config
        return (cfg.moe_num_experts > 0
                and (i + 1) % cfg.moe_every_n_layers == 0)

    def forward(self, input_ids, caches=None, pos=None, paged=None,
                adapters=None):
        """With `caches`: (hidden, caches) with positions offset by `pos`
        (an int offsets the whole batch, a [B] tensor each row), and
        `adapters` = (per-layer banks, adapter_idx [B], scale [K]) the
        per-row LoRA operand (ops/lora.py). Without: (hidden, total aux
        loss), positions 0..S-1; the aux loss is the sum over the MoE
        layers, None for a dense model."""
        S = input_ids.shape[1]
        dev = input_ids.device
        ar = torch.arange(S, device=dev)
        if caches is None:
            hidden = self.dropout(self.word_embeddings(input_ids)
                                  + self.position_embeddings(ar))
            total_aux = None
            for layer in self.layers:
                hidden, aux = layer(hidden)
                if aux is not None:
                    total_aux = aux if total_aux is None else total_aux + aux
            return self.final_norm(hidden), total_aux
        if torch.is_tensor(pos) and pos.ndim == 1:
            pos_ids = pos.to(device=dev, dtype=torch.long)[:, None] + ar
        else:
            pos_ids = int(pos) + ar
        hidden = self.word_embeddings(input_ids) + \
            self.position_embeddings(pos_ids)
        hidden = self.dropout(hidden)
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            layer_ad = None if adapters is None else (
                adapters[0][i], adapters[1], adapters[2])
            hidden, nc = layer(hidden, cache, pos, paged=paged,
                               adapters=layer_ad)
            new_caches.append(nc)
        return self.final_norm(hidden), new_caches


class GPTForCausalLM(Layer):
    """GPT with an lm head. `device` defaults to CUDA (raises without a
    GPU; pass device="cpu" for the plain path); `dtype` to float32;
    weights are drawn from `generator` (a torch.Generator on `device`,
    seeded 0 when None)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or torch.float32
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype)
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
        tokens of the cross-entropy (ignore_index -100 tokens count as 0),
        an fp32 scalar: the chunked lm-head + CE by default, or, with the
        environment's FLAGS_fused_lm_ce set to anything but 1, the logits
        through the lm head (an autocast op under AMP) and
        `ParallelCrossEntropy`, as in the JAX package (gpt.py:314-325).
        Without labels: logits [B, S, V]. An MoE model's loss adds the
        layers' aux loss times moe_aux_loss_weight on either path."""
        hidden, total_aux = self.gpt(input_ids)
        if labels is None:
            return self.lm_head(hidden)
        if self._can_fuse_lm_ce():
            hs = hidden.reshape(-1, hidden.shape[-1])
            loss = fused_linear_cross_entropy(
                hs, self.lm_head.weight, labels.reshape(-1)).mean()
        else:
            loss = self.loss_fn(self.lm_head(hidden), labels).mean()
        if total_aux is not None:
            loss = loss + total_aux * self.config.moe_aux_loss_weight
        return loss

    def _can_fuse_lm_ce(self):
        """FLAGS_fused_lm_ce (default 1) read at every call, as the JAX
        model reads it; a vocab-sharded lm head (mp degree > 1) keeps the
        ParallelCrossEntropy path, as in JAX (gpt.py:314-327)."""
        import os
        return (os.environ.get("FLAGS_fused_lm_ce", "1") == "1"
                and self.lm_head.world_size == 1)

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        cfg = self.config
        if max_len > cfg.max_position_embeddings:
            # the learned position table cannot decode past its end
            raise ValueError(
                f"init_cache: max_len={max_len} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings}; "
                "GPT's learned position table cannot decode past it")
        dt = convert_dtype(dtype) or self.dtype
        shape = (batch_size, cfg.num_attention_heads, max_len, cfg.head_dim)
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
        hidden, new_caches = self.gpt(input_ids, caches, pos, paged=paged,
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

    @classmethod
    def from_preset(cls, name: str, device=None, dtype=None,
                    generator: Optional[torch.Generator] = None,
                    **overrides):
        cfg = dataclasses.replace(GPT_PRESETS[name], **overrides)
        return cls(cfg, device=device, dtype=dtype, generator=generator)
