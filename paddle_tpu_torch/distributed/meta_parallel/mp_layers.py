"""Megatron tensor-parallel layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py:43-162).

Each layer reads the model-parallel degree, rank and group of the hybrid
group (`fleet.init`) when it is built. At degree 1 it is the plain layer
with the JAX package's parameter names and layouts. Above it holds only
its shard of the weight, and runs the reference's explicit path over
the model-parallel group:
- `VocabParallelEmbedding`: rows [V/n], ids outside the rank's range
  masked to 0, then `_mp_allreduce`;
- `ColumnParallelLinear`: W [in, out/n] and b [out/n]; `_c_identity`,
  the product, then `_c_concat` when `gather_output`;
- `RowParallelLinear`: W [in/n, out], b [out] whole; `_c_split` unless
  `input_is_parallel`, the product, `_mp_allreduce`, then the bias;
- `ParallelCrossEntropy`: the vocab-sharded CE over the group; it keeps
  `ignore_index` at every degree (the JAX layer drops it off tensor
  parallelism, ROADMAP §3 item 6).

Every parameter carries the JAX layer's `partition_spec` as a tuple of
axis names (`("model", None)` for a weight split on dim 0), which the
train step and `bridge.shard_state` read, and `is_distributed` (True for
a shard). A layer draws its weight whole from the generator and keeps its
slice, so one seed makes one logical model at every degree.
"""
from __future__ import annotations

import torch

from ...nn.functional import linear
from ...nn.functional.loss import softmax_with_cross_entropy
from ...nn.layer.common import Linear, xavier_normal_
from ...nn.layer.layers import Layer, create_parameter
from ..collective import (_c_concat, _c_identity, _c_softmax_with_cross_entropy,
                          _c_split, _mp_allreduce)
from ..topology import get_hybrid_communicate_group

MODEL_AXIS = "model"


def _mp():
    """(degree, rank, group) of model parallelism in the hybrid group;
    (1, 0, None) without one."""
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() == 1:
        return 1, 0, None
    return (hcg.get_model_parallel_world_size(),
            hcg.get_model_parallel_rank(), hcg.get_model_parallel_group())


def mp_degree() -> int:
    return _mp()[0]


def is_mp_shard(p) -> bool:
    """Whether `p` holds a shard split over model parallelism: the flag
    `_tag` sets. A torch tensor also has a method `is_distributed`, so a
    plain `getattr` would call every untagged (replicated) leaf one."""
    return getattr(p, "is_distributed", False) is True


def _tag(p, spec, distributed):
    if p is not None:
        p.partition_spec = spec
        p.is_distributed = distributed


def _fill_slice(p, dim, rank, draw):
    """Draw the full logical tensor with `draw(full)` and keep this rank's
    slice of `dim` in p."""
    if p.n_shards == 1:
        draw(p)
        return
    shape = list(p.shape)
    n = shape[dim]
    shape[dim] = n * p.n_shards
    full = torch.empty(shape, device=p.device, dtype=p.dtype)
    draw(full)
    p.copy_(full.narrow(dim, rank * n, n))


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, weight_attr=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.world_size, self.rank, self._group = _mp()
        if num_embeddings % self.world_size:
            raise ValueError(f"vocab size {num_embeddings} must divide by "
                             f"the mp degree {self.world_size}")
        self.weight = create_parameter(
            [num_embeddings // self.world_size, embedding_dim], device,
            dtype, weight_attr)
        self.weight.n_shards = self.world_size
        _tag(self.weight, (MODEL_AXIS, None), self.world_size > 1)

    def reset_parameters(self, generator=None):
        _fill_slice(self.weight, 0, self.rank,
                    lambda w: xavier_normal_(w, generator))

    def forward(self, ids):
        ids = ids.long()
        if self.world_size == 1:
            return torch.nn.functional.embedding(ids, self.weight)
        n_shard = self.weight.shape[0]
        local = ids - self.rank * n_shard
        in_range = (local >= 0) & (local < n_shard)
        out = torch.nn.functional.embedding(local.clamp(0, n_shard - 1),
                                            self.weight)
        out = torch.where(in_range[..., None], out, 0.0).to(out.dtype)
        return _mp_allreduce(out, group=self._group)


class _ParallelLinear(Linear):
    """`Linear` over this rank's shard (split on `_split_dim`), with the
    tensor-parallel layers' xavier-normal init of the whole weight."""

    _split_dim = 1

    def __init__(self, in_features, out_features, has_bias, device, dtype,
                 weight_attr):
        Layer.__init__(self)
        self.world_size, self.rank, self._group = _mp()
        n = self.world_size
        split = (in_features, out_features)[self._split_dim]
        if split % n:
            raise ValueError(f"{type(self).__name__}: {split} features "
                             f"must divide by the mp degree {n}")
        self.in_features = in_features
        self.out_features = out_features
        shape = [in_features, out_features]
        shape[self._split_dim] //= n
        self.weight = create_parameter(shape, device, dtype, weight_attr)
        self.weight.n_shards = n
        self.bias = (create_parameter(
            [out_features // n if self._split_dim == 1 else out_features],
            device, dtype) if has_bias else None)

    def reset_parameters(self, generator=None):
        _fill_slice(self.weight, self._split_dim, self.rank,
                    lambda w: xavier_normal_(w, generator))
        if self.bias is not None:
            self.bias.zero_()


class ColumnParallelLinear(_ParallelLinear):
    """W [in, out] split on the output dim: Y_local = X @ W_local + b_local."""

    _split_dim = 1

    def __init__(self, in_features, out_features, has_bias=None,
                 gather_output=True, device=None, dtype=None,
                 weight_attr=None):
        super().__init__(in_features, out_features,
                         has_bias is None or has_bias, device, dtype,
                         weight_attr)
        self.gather_output = gather_output
        dist = self.world_size > 1
        _tag(self.weight, (None, MODEL_AXIS), dist)
        _tag(self.bias, (MODEL_AXIS,), dist)

    def forward(self, x):
        if self.world_size == 1:
            return linear(x, self.weight, self.bias)
        out = linear(_c_identity(x, self._group), self.weight, self.bias)
        return _c_concat(out, self._group) if self.gather_output else out


class RowParallelLinear(_ParallelLinear):
    """W [in, out] split on the input dim: Y = allreduce(X_local @
    W_local) + b."""

    _split_dim = 0

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, device=None, dtype=None,
                 weight_attr=None):
        super().__init__(in_features, out_features, has_bias, device, dtype,
                         weight_attr)
        self.input_is_parallel = input_is_parallel
        _tag(self.weight, (MODEL_AXIS, None), self.world_size > 1)
        _tag(self.bias, (None,), False)

    def forward(self, x):
        if self.world_size == 1:
            return linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _c_split(x, self._group)
        out = _mp_allreduce(linear(x, self.weight), group=self._group)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class ParallelCrossEntropy(Layer):
    """Softmax cross-entropy over vocab-sharded logits: the per-token fp32
    loss, 0 where the label is `ignore_index`; at degree 1
    `softmax_with_cross_entropy`. (The JAX layer's unsharded path drops
    `ignore_index` and always ignores -100; this one honours it.)"""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.world_size, self.rank, group = _mp()
        self._group = mp_group or group

    def forward(self, input, label):
        if self.world_size == 1:
            return softmax_with_cross_entropy(input, label,
                                              ignore_index=self.ignore_index)
        return _c_softmax_with_cross_entropy(input, label, self._group,
                                             self.ignore_index)
