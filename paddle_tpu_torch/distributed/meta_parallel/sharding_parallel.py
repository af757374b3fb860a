"""ShardingParallel (counterpart of
paddle_tpu/distributed/meta_parallel/sharding_parallel.py): the model
wrapper of `fleet.distributed_model` under sharding. When it wraps, it
broadcasts every parameter from the first rank of the sharding and the
data groups, as the reference's wrapper does. Forward and the state pass
through; the ZeRO layout is the train step's (`parallel/hybrid.py`) or
`DygraphShardingOptimizer`'s."""
from __future__ import annotations

from ..data_parallel import broadcast_parameters
from .tensor_parallel import _Wrapper


class ShardingParallel(_Wrapper):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        broadcast_parameters(layers, self._hcg.get_sharding_parallel_group())
        broadcast_parameters(layers, self._hcg.get_data_parallel_group())
