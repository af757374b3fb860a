"""paddle.distributed (counterpart of paddle_tpu/distributed/): process
groups and collectives (`collective`, `parallel_env`, `spawn`), the hybrid
topology (`topology`), data parallelism (`data_parallel`), the fleet
facade with its strategy compiler, the tensor-parallel layers
(`meta_parallel`), the dataset run loops (`trainer`) and the resilient
training runtime (`resilient`). One process a rank, on
`torch.distributed`. Compression and DGC, pipeline, sequence and expert
parallelism, LocalSGD, the fleet dataset, elastic, launch and cloud_utils
wait for their sub-items of ROADMAP §1 item 8."""
from . import fleet  # noqa: F401
from . import utils  # noqa: F401
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_gather_concat, all_reduce, all_to_all_single,
                         alltoall, barrier, broadcast, destroy_process_group,
                         get_default_group, get_group, new_group, recv,
                         reduce, reduce_scatter, scatter, send, wait)
from .data_parallel import DataParallel  # noqa: F401
from .parallel_env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                           init_parallel_env, is_initialized)
from .resilient import (ResilientConfig, ResilientTrainer,  # noqa: F401
                        UnrecoverableError)
from .spawn import spawn  # noqa: F401
from .strategy import DistributedStrategy, QuantAllreduceConfig  # noqa: F401
from .topology import (CommunicateTopology, HybridCommunicateGroup,  # noqa: F401
                       HybridMesh, ParallelMode, build_mesh_from_dims,
                       get_hybrid_communicate_group, get_mesh, set_mesh,
                       set_hybrid_communicate_group)
from .trainer import DeviceWorker, MultiTrainer, train_from_dataset  # noqa: F401


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None, device=None,
          generator=None):
    """The reference's row/column-parallel helper: the meta_parallel
    layer for `operation` ("linear" with axis 0 row-split or 1
    column-split, or "embedding") of `size` over the hybrid group's model
    parallelism, its weights drawn from `generator` (seeded 0 when None)
    on `device` (CUDA unless "cpu"). As the JAX `split`, it returns the
    layer and leaves `x` alone."""
    import torch
    from ..core.device import resolve_device
    from ..nn.layer.layers import init_parameters
    from . import meta_parallel as mp
    device = resolve_device(device)
    if operation == "linear":
        if axis == 0:
            layer = mp.RowParallelLinear(size[0], size[1],
                                         has_bias=bias_attr is not False,
                                         input_is_parallel=False,
                                         device=device,
                                         weight_attr=weight_attr)
        else:
            layer = mp.ColumnParallelLinear(size[0], size[1],
                                            has_bias=bias_attr is not False,
                                            gather_output=gather_out,
                                            device=device,
                                            weight_attr=weight_attr)
    elif operation == "embedding":
        layer = mp.VocabParallelEmbedding(size[0], size[1], device=device,
                                          weight_attr=weight_attr)
    else:
        raise ValueError(f"unsupported split operation {operation}")
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    init_parameters(layer, generator)
    return layer
