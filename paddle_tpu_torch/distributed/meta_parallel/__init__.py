from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding)
from .sharding_parallel import ShardingParallel  # noqa: F401
from .tensor_parallel import TensorParallel  # noqa: F401
