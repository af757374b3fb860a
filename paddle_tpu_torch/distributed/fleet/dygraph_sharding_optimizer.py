"""Stage-1 eager sharding optimizer (counterpart of
paddle_tpu/distributed/fleet/dygraph_sharding_optimizer.py).

Each sharding rank owns a greedy size-balanced subset of the parameters
(the JAX `_partition_parameters`: largest first, each to the rank with
the fewest elements so far). A step averages the gradients over the
batch ranks, the data and the sharding groups (each ran its own slice of
the batch), updates the owned parameters only, so only their optimizer
state exists on the rank, then broadcasts each updated parameter from
its owner over the sharding group, one collective an (owner, bucket). A
global-norm clip becomes the hybrid clip over the owned leaves, summed
over sharding. `fleet.distributed_optimizer` routes as the JAX facade
does and gives `HybridParallelOptimizer` in every mode but pure data
parallelism, so this class is built directly; the train step's ZeRO
(`parallel/hybrid.py`) is the sharded path of `parallelize`."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...nn.clip import ClipGradByGlobalNorm
from .. import collective as C
from .hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                        sync_batch_grads)


class DygraphShardingOptimizer:
    def __init__(self, optimizer, hcg=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._group = hcg.get_sharding_parallel_group() if hcg else None
        self._sharding_world_size = (
            hcg.get_sharding_parallel_world_size() if hcg else 1)
        self._sharding_rank = hcg.get_sharding_parallel_rank() if hcg else 0
        self._rank2params = self._partition_parameters()
        self._full_parameter_list = list(optimizer._parameter_list or [])
        optimizer._parameter_list = self._rank2params[self._sharding_rank]
        if hcg is not None and isinstance(optimizer._grad_clip,
                                          ClipGradByGlobalNorm):
            # the inner step sees the owned leaves only: their squares
            # summed over sharding make the global norm
            optimizer._grad_clip = HybridParallelClipGrad(
                optimizer._grad_clip, hcg, owned=True)

    def _partition_parameters(self) -> Dict[int, List]:
        """Greedy size-balanced partition (largest first, stable)."""
        mapping = {i: [] for i in range(self._sharding_world_size)}
        sizes = [0.0] * self._sharding_world_size
        params = list(self._inner_opt._parameter_list or [])
        for param in sorted(params, key=lambda p: -p.numel()):
            dst = int(np.argmin(sizes))
            mapping[dst].append(param)
            sizes[dst] += param.numel()
        return mapping

    @property
    def _parameter_list(self):
        return self._full_parameter_list

    def _reduce_gradients(self):
        """Average every gradient over the batch ranks (data and
        sharding), as `HybridParallelOptimizer` does."""
        if self._hcg is not None:
            sync_batch_grads(self._full_parameter_list, self._hcg)

    def step(self):
        self._reduce_gradients()
        self._inner_opt.step()
        self._sharding_sync_parameters()

    def _sharding_sync_parameters(self):
        """Broadcast each owner's updated parameters over the sharding
        group, one collective an (owner, bucket)."""
        if self._sharding_world_size <= 1:
            return
        g = self._group
        for owner, params in self._rank2params.items():
            C.flat_apply([p.detach() for p in params],
                         lambda flat: C.broadcast(flat, g.ranks[owner],
                                                  group=g))

    def clear_grad(self, set_to_zero=True):
        for p in self._full_parameter_list:
            if p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        return None, []

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
