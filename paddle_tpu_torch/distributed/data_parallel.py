"""DataParallel (counterpart of paddle_tpu/distributed/data_parallel.py).

The eager path of data parallelism: each rank runs its own slice of the
batch through the wrapped model, and `apply_collective_grads()` averages
the gradients over the data group (the hybrid group's, after
`fleet.init`; else the world) as the reference's reducer does: gradients
grouped by dtype into buckets of at most `comm_buffer_size` MB, one
all-reduce a bucket, each in its gradient's own dtype (the flat
buckets of `collective.flat_apply`). The wrapper
broadcasts the parameters from the group's first rank when it is built,
so every rank starts from the same weights.

`sync_gradients_fn(axis, average, comm_dtype)` is the functional form:
fn(grads) -> grads (a dict or a list) averaged (or summed) over the
hybrid group's `axis`, the fp32 ones crossing in `comm_dtype` when given
(strategy.fp16_allreduce). The JAX module's quantized reducer
(`comm_quant`, `strategy.quant_allreduce`) waits for compression
(ROADMAP §1 item 8a).
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from . import collective as C
from .meta_parallel.mp_layers import is_mp_shard
from .topology import get_hybrid_communicate_group

_QUANT = "quantized gradient collectives wait for compression, " \
    "ROADMAP §1 item 8a"


def _data_group():
    hcg = get_hybrid_communicate_group()
    return hcg.get_data_parallel_group() if hcg is not None else None


def broadcast_parameters(model, group, replicated_only=False):
    """Every parameter (or only those not split over model parallelism)
    from `group`'s first rank, one collective a bucket."""
    if group is None:
        group = C.get_default_group()
    if group.nranks <= 1:
        return
    params = [p.detach() for p in model.parameters()
              if not (replicated_only and is_mp_shard(p))]
    C.flat_apply(params, lambda flat: C.broadcast(flat, group.ranks[0],
                                                  group=group))


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        if strategy is not None and getattr(strategy, "quant_allreduce",
                                            False):
            raise NotImplementedError(f"strategy.quant_allreduce: {_QUANT}")
        self._layers = layers
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        self._group = group or _data_group() or C.get_default_group()
        broadcast_parameters(layers, self._group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The loss as it is: `apply_collective_grads` averages (the
        reference's 1/N scale is inside its mean)."""
        return loss

    def apply_collective_grads(self):
        """Average every gradient over the data group: dtype buckets of at
        most comm_buffer_size MB, one all-reduce a bucket."""
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        C.average_over(grads, [self._group], self.comm_buffer_size)

    # passthrough conveniences
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kw):
        return self._layers.named_parameters(prefix, recurse, **kw)


def _bucket_grads(params, comm_buffer_size_mb):
    """Parameters with gradients in buckets of at most
    `comm_buffer_size_mb` MB of gradient bytes (numel x element size),
    never mixing dtypes, in order (the JAX `_bucket_grads`)."""
    return [[params[i] for i in b] for b in
            C.buckets([p.grad for p in params], comm_buffer_size_mb)]


def sync_gradients_fn(axis: str = "data", average: bool = True,
                      comm_dtype=None, comm_quant=None):
    """fn(grads) -> grads reduced over the hybrid group's `axis` (the
    world without a hybrid group): the mean (or the sum) of each leaf,
    fp32 leaves crossing in `comm_dtype` when given."""
    if comm_quant is not None:
        raise NotImplementedError(f"comm_quant: {_QUANT}")
    from ..core.dtype import convert_dtype
    cd = convert_dtype(comm_dtype) if comm_dtype else None

    def group():
        hcg = get_hybrid_communicate_group()
        return hcg.get_group(axis) if hcg is not None else \
            C.get_default_group()

    @torch.no_grad()
    def one(g, grp):
        wire = g.to(cd) if cd is not None and g.dtype == torch.float32 \
            else g.clone()
        C.all_reduce(wire, C.ReduceOp.AVG if average else C.ReduceOp.SUM,
                     group=grp)
        return wire.to(g.dtype)

    def sync(grads):
        grp = group()
        if isinstance(grads, dict):
            return {k: one(g, grp) for k, g in grads.items()}
        return [one(g, grp) for g in grads]

    return sync
