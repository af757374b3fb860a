"""HybridParallelOptimizer and HybridParallelClipGrad (counterpart of
paddle_tpu/distributed/fleet/hybrid_parallel_optimizer.py).

`HybridParallelClipGrad` is the global-norm clip over shards. The JAX
step takes the norm of the logical arrays, so a replicated leaf counts
once. Here each rank holds shards, so the squared norms are summed in
four kinds: a leaf sharded over model and sharding (summed over both
groups), over model only (`is_distributed`, summed over model), over
sharding only (`zero_sharded`, summed over sharding), and a replicated
leaf (LayerNorm, a row-parallel bias, a leaf under ZeRO's `min_numel`),
counted once. Nothing is summed over data: the data ranks' gradients are
equal after their average. `need_clip` False leaves a leaf out of the
norm and unscaled, as `ClipGradByGlobalNorm` does.

`HybridParallelOptimizer` wraps the user's optimizer for the eager path
(`fleet.distributed_optimizer`, in every mode but pure data
parallelism, as the JAX facade routes it): its step averages the
gradients over the batch ranks, the data and the sharding groups
(`sync_batch_grads`, the reference's fused_allreduce_gradients), then
runs the inner step with the hybrid clip in place of a global-norm
clip. Every rank steps every parameter it holds, so the sharding ranks
keep equal parameters without a broadcast.
"""
from __future__ import annotations

import torch

from ...nn.clip import ClipGradBase, ClipGradByGlobalNorm
from .. import collective as C
from ..meta_parallel.mp_layers import is_mp_shard
from ..parallel_env import current_device


def sync_batch_grads(params, hcg):
    """The eager wrappers' gradient sync: each gradient of `params` the
    mean over the data and sharding groups together (the batch axes)."""
    C.average_over([p.grad for p in params if p.grad is not None],
                   (hcg.get_data_parallel_group(),
                    hcg.get_sharding_parallel_group()))


class HybridParallelClipGrad(ClipGradBase):
    """`owned=True`: every leaf's square is summed over sharding, for an
    optimizer that clips only the leaves its sharding rank owns (the
    eager `DygraphShardingOptimizer`)."""

    def __init__(self, clip, hcg, owned=False):
        self._clip = clip
        self._hcg = hcg
        self._owned = owned
        self.clip_norm = clip.clip_norm

    def __call__(self, params_grads):
        params_grads = list(params_grads)
        live = [(p, g) for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)]
        # every rank joins the collectives below, with leaves or without
        dev = live[0][1].device if live else current_device()
        sq = torch.zeros(4, dtype=torch.float32, device=dev)
        for p, g in live:
            kind = (2 * is_mp_shard(p)
                    + (self._owned or bool(getattr(p, "zero_sharded",
                                                   False))))
            # 3: model and sharding, 2: model, 1: sharding, 0: replicated
            sq[kind] += g.float().square().sum()
        hcg = self._hcg
        both = torch.stack([sq[3], sq[1]])
        C.all_reduce(both, group=hcg.get_sharding_parallel_group())
        mp = (both[0] + sq[2]).reshape(1)
        C.all_reduce(mp, group=hcg.get_model_parallel_group())
        gnorm = (mp[0] + both[1] + sq[0]).sqrt()
        f = torch.clamp_max(
            self.clip_norm / gnorm.clamp_min(self.clip_norm), 1.0)
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else (g.float() * f).to(g.dtype))
                for p, g in params_grads]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if isinstance(optimizer._grad_clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(
                optimizer._grad_clip, hcg)

    @property
    def _parameter_list(self):
        return self._inner_opt._parameter_list

    def _dp_sync(self):
        """Average every gradient over the batch ranks: the data group and
        the sharding group, whose ranks each ran their own slice of the
        batch (one collective a bucket and group)."""
        sync_batch_grads(self._parameter_list, self._hcg)

    def step(self):
        self._dp_sync()
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, []

    def get_lr(self):
        return self._inner_opt.get_lr()

    def set_lr(self, value):
        return self._inner_opt.set_lr(value)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
