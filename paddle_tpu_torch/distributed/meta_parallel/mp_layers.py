"""Tensor-parallel layers at degree 1 (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py:43-162).

Plain layers with the JAX package's parameter names and layouts: the
vocab-sharded embedding and the column/row-split linears hold the full
logical weight, and the vocab-sharded cross-entropy is the unsharded
one. Real tensor parallelism waits for the multi-GPU slice.
"""
from __future__ import annotations

import torch

from ...nn.functional.loss import softmax_with_cross_entropy
from ...nn.layer.common import Linear, xavier_normal_
from ...nn.layer.layers import Layer, create_parameter


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, weight_attr=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = create_parameter([num_embeddings, embedding_dim],
                                       device, dtype, weight_attr)

    def reset_parameters(self, generator=None):
        xavier_normal_(self.weight, generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class _ParallelLinear(Linear):
    """`Linear` with the tensor-parallel layers' xavier-normal init."""

    def reset_parameters(self, generator=None):
        xavier_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()


class ColumnParallelLinear(_ParallelLinear):
    """W [in, out] split on the output dim; whole at degree 1."""

    def __init__(self, in_features, out_features, has_bias=None,
                 gather_output=True, device=None, dtype=None,
                 weight_attr=None):
        super().__init__(in_features, out_features,
                         has_bias is None or has_bias, device, dtype,
                         weight_attr=weight_attr)
        self.gather_output = gather_output


class RowParallelLinear(_ParallelLinear):
    """W [in, out] split on the input dim; whole at degree 1."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, device=None, dtype=None,
                 weight_attr=None):
        super().__init__(in_features, out_features, has_bias, device, dtype,
                         weight_attr=weight_attr)
        self.input_is_parallel = input_is_parallel


class ParallelCrossEntropy(Layer):
    """Softmax cross-entropy over vocab-sharded logits; at degree 1 it is
    `softmax_with_cross_entropy`: the per-token fp32 loss, 0 where the
    label is `ignore_index`. (The JAX layer's unsharded path drops
    `ignore_index` and always ignores -100; this one honours it.)"""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return softmax_with_cross_entropy(input, label,
                                          ignore_index=self.ignore_index)
