"""TensorParallel (counterpart of
paddle_tpu/distributed/meta_parallel/tensor_parallel.py): the model
wrapper of `fleet.distributed_model` under tensor parallelism. When it
wraps, it broadcasts the parameters that every model-parallel rank holds
whole from the group's first rank, and every parameter over the data
(and sharding) groups, as the reference's wrapper does; the split ones
are each rank's own. Forward and the state pass through."""
from __future__ import annotations

from ...nn.layer.layers import Layer
from ..data_parallel import broadcast_parameters
from ..topology import get_hybrid_communicate_group


class _Wrapper(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kw):
        return self._layers.named_parameters(prefix, recurse, **kw)


class TensorParallel(_Wrapper):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        h = self._hcg
        broadcast_parameters(layers, h.get_model_parallel_group(),
                             replicated_only=True)
        broadcast_parameters(layers, h.get_data_parallel_group())
        broadcast_parameters(layers, h.get_sharding_parallel_group())
