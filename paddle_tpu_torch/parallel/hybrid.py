"""The multi-rank layout of a train step: one process a rank over the
hybrid group (counterpart of the GSPMD layout of
paddle_tpu/parallel/api.py:33-97 and 269-330).

The JAX step lays out logical arrays over a mesh with PartitionSpecs
and lets XLA insert the collectives. Here rank r holds what mesh position
r holds there, in `CommunicateTopology` order (data, pipe, sharding,
model), and the step runs the collectives itself:

- parameters follow `_param_spec`: the tensor-parallel layers allocate
  their `model` shard when they are built;
- ZeRO follows `_zero_spec` over `sharding` (leaves under `min_numel`
  stay whole): stage 1 shards the optimizer's moments, stage 2 also
  reduce-scatters the gradients, stage 3 also keeps only the parameter's
  shard between steps. Stage 3 all-gathers every parameter before the
  forward and keeps them whole through the backward and the update (the
  JAX step gathers each around its use, inside XLA), so it saves the
  parameters' memory between steps only and peaks as stage 2 does. A dim
  that `_zero_spec` shards over ("model", "sharding") holds slice
  `model_idx * S + sharding_idx`, which is slice `sharding_idx` of this
  rank's model shard. Each shard is its own contiguous tensor, which the
  optimizer (fused Adam) updates;
- the global batch splits over `_batch_axes` in (data, sharding) order,
  and the gradients are averaged over them: a sum over data, then over
  sharding (a reduce-scatter for the sharded leaves of stage 2 and 3),
  in the flat dtype buckets of `collective.flat_apply`;
- the returned loss is the mean of the batch ranks' losses, as the JAX
  step's is over the global batch.

Specs are tuples of axis names (None, an axis, or a tuple of axes a dim),
the JAX PartitionSpecs' entries.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..distributed import collective as C


def _param_spec(param, mesh) -> tuple:
    """The parameter's `partition_spec` with the axes the mesh lacks, or
    has at size 1, dropped (the JAX `_param_spec`)."""
    spec = getattr(param, "partition_spec", None)
    if spec is None:
        return ()
    return tuple(None if ax is None or ax not in mesh.axis_names
                 or mesh.shape[ax] == 1 else ax for ax in spec)


def _zero_spec(base, shape, mesh, axis="sharding", min_numel=1024) -> tuple:
    """`base` extended with the ZeRO axis on the first dim that takes it
    (the JAX `_zero_spec`, api.py:50-86): stacked onto an already-sharded
    dim where the combined group divides it, else the first free dim
    that divides; unchanged under `min_numel` or where nothing divides."""
    base = tuple(base)
    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return base
    if int(np.prod(shape)) < min_numel:
        return base
    spec = list(base) + [None] * (len(shape) - len(base))
    for ax in spec:
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return tuple(spec)
    for dim, ax in enumerate(spec):
        if ax is None or ax == axis:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if axis in axes:
            continue
        group = int(np.prod([mesh.shape[a] for a in axes])) * \
            mesh.shape[axis]
        if shape[dim] % group == 0:
            spec[dim] = tuple(axes) + (axis,)
            return tuple(spec)
    for dim, ax in enumerate(spec):
        if ax is None and shape[dim] % mesh.shape[axis] == 0 and \
                shape[dim] > 1:
            spec[dim] = axis
            return tuple(spec)
    return base


def _batch_axes(mesh):
    """The axes the global batch splits over, in order (the JAX
    `_batch_axes`); None when it is whole on every rank."""
    axes = [ax for ax in ("data", "sharding", "ep") if ax in mesh.axis_names
            and mesh.shape[ax] > 1]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_of(arr, spec, mesh):
    """This rank's block of the logical array `arr` under `spec`: on each
    dim with axes (a1, a2, ...), slice number c[a1]·n[a2]·... + c[a2]·...
    of n[a1]·n[a2]·... equal slices (major to minor)."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coord[a]
            n *= mesh.shape[a]
        size = arr.shape[dim] // n
        arr = arr.narrow(dim, idx * size, size) if torch.is_tensor(arr) \
            else arr[(slice(None),) * dim + (slice(idx * size,
                                                   (idx + 1) * size),)]
    return arr


def _dim_of(spec, axis):
    for dim, entry in enumerate(spec):
        if axis in _axes(entry):
            return dim
    return None


class _Leaf:
    """One trainable parameter's layout on this rank."""

    def __init__(self, param, mesh, zero_stage, min_numel):
        self.param = param
        spec = _param_spec(param, mesh)
        self.mp_dim = _dim_of(spec, "model")
        logical = list(param.shape)
        if self.mp_dim is not None:
            logical[self.mp_dim] *= mesh.shape["model"]
        if zero_stage >= 1:
            spec = _zero_spec(spec, logical, mesh, min_numel=min_numel)
        self.zero_dim = _dim_of(spec, "sharding")
        self.local_shape = tuple(param.shape)
        shard = list(param.shape)
        if self.zero_dim is not None:
            shard[self.zero_dim] //= mesh.shape["sharding"]
        self.shard_shape = tuple(shard)
        self.shard = None       # the contiguous ZeRO shard the optimizer owns
        self.written = None     # the parameter's (data_ptr, _version) as
        #                         the layout last wrote it


_ATTRS = ("need_clip", "optimize_attr", "regularizer", "attr_name",
          "partition_spec", "is_distributed")


class HybridLayout:
    """The per-rank collectives and shards of a multi-rank step."""

    def __init__(self, mesh, params, zero_stage, min_numel=1024):
        self.mesh = mesh
        hcg = mesh.hcg
        self.zero_stage = zero_stage
        self.S = mesh.shape.get("sharding", 1)
        self.sharding_rank = mesh.coord.get("sharding", 0)
        self.dp_group = hcg.get_data_parallel_group()
        self.sharding_group = hcg.get_sharding_parallel_group()
        self.mp_group = hcg.get_model_parallel_group()
        self.world = hcg.get_world_group()
        ba = _batch_axes(mesh)
        self.batch_axes = () if ba is None else (
            ba if isinstance(ba, tuple) else (ba,))
        self.n_batch = int(np.prod([mesh.shape[a] for a in self.batch_axes]))
        self.batch_index = 0
        for a in self.batch_axes:
            self.batch_index = self.batch_index * mesh.shape[a] + \
                mesh.coord[a]
        self.leaves: List[_Leaf] = [
            _Leaf(p, mesh, zero_stage, min_numel) for p in params]
        with torch.no_grad():
            for leaf in self.leaves:
                if leaf.zero_dim is None:
                    continue
                leaf.shard = self._own(leaf.param.detach(), leaf).clone()
                for a in _ATTRS:        # the attributes set on the param
                    if a in leaf.param.__dict__:
                        setattr(leaf.shard, a, leaf.param.__dict__[a])
                leaf.shard.zero_sharded = True
        self._mark_written()
        if zero_stage >= 3:
            self.release_params()

    # ---- the tensors the optimizer updates ----
    def update_tensors(self):
        return [leaf.param if leaf.shard is None else leaf.shard
                for leaf in self.leaves]

    def _own(self, t, leaf):
        """This rank's ZeRO slice of a full local tensor, contiguous."""
        n = t.shape[leaf.zero_dim] // self.S
        return t.narrow(leaf.zero_dim, self.sharding_rank * n,
                        n).contiguous()

    # ---- the batch ----
    def local_batch(self, t, dim=0):
        """This rank's slice of the global batch dim `dim`."""
        if self.n_batch == 1:
            return t
        B = t.shape[dim]
        if B % self.n_batch:
            raise ValueError(f"global batch {B} does not divide over the "
                             f"{self.n_batch} batch ranks {self.batch_axes}")
        n = B // self.n_batch
        return t.narrow(dim, self.batch_index * n, n)

    def mean_loss(self, loss):
        """The mean over the batch ranks (the loss of the global batch)."""
        if self.n_batch == 1:
            return loss
        out = loss.detach().clone().reshape(1)
        C.average_over([out], (self.dp_group, self.sharding_group))
        return out.reshape(())

    def _rows(self, t, leaf):
        """[S, numel/S]: row i is ZeRO slice i of `t` (contiguous)."""
        return torch.stack([c.reshape(-1) for c in
                            t.chunk(self.S, leaf.zero_dim)])

    # ---- gradients ----
    @torch.no_grad()
    def sync_grads(self, grads):
        """The gradients the optimizer takes, from each rank's local ones:
        averaged over the batch ranks, and for a ZeRO leaf this rank's
        slice (reduce-scattered at stage 2 and 3)."""
        scale = 1.0 / self.n_batch
        grads = [None if g is None else g.contiguous() for g in grads]
        out = list(grads)
        whole, scattered = [], []
        for i, (leaf, g) in enumerate(zip(self.leaves, grads)):
            if g is None:
                continue
            if leaf.zero_dim is not None and self.zero_stage >= 2:
                scattered.append(i)
            else:
                whole.append(i)
        # the whole gradients summed over data and sharding; the scattered
        # ones over data here and over sharding by the reduce-scatter
        C.sum_over([grads[i] for i in whole],
                   (self.dp_group, self.sharding_group), scale)
        C.sum_over([grads[i] for i in scattered], (self.dp_group,), scale)
        for i in whole:
            leaf = self.leaves[i]
            out[i] = (self._own(grads[i], leaf) if leaf.zero_dim is not None
                      else grads[i])
        for b in C.buckets([grads[i] for i in scattered]):
            idx = [scattered[j] for j in b]
            rows = torch.cat([self._rows(grads[i], self.leaves[i])
                              for i in idx], 1)
            mine = torch.empty(rows.shape[1], dtype=rows.dtype,
                               device=rows.device)
            C.reduce_scatter(mine, list(rows.unbind(0)),
                             group=self.sharding_group)
            off = 0
            for i in idx:
                leaf = self.leaves[i]
                n = grads[i].numel() // self.S
                out[i] = mine[off:off + n].view(leaf.shard_shape)
                off += n
        return out

    def agree_finite(self, finite):
        """The fp16 census agreed over every rank (a max all-reduce of
        the not-finite flag), on the device."""
        flag = (~finite).to(torch.float32).reshape(1)
        C.all_reduce(flag, C.ReduceOp.MAX, group=self.world)
        return (flag == 0).reshape(())

    # ---- parameters ----
    @torch.no_grad()
    def gather_params(self):
        """Every ZeRO parameter whole again: the shards all-gathered over
        sharding, one collective a bucket."""
        zl = [lf for lf in self.leaves if lf.shard is not None]
        for b in C.buckets([lf.shard for lf in zl]):
            bucket = [zl[j] for j in b]
            flat = torch.cat([lf.shard.reshape(-1) for lf in bucket])
            rows = C.all_gather([], flat, group=self.sharding_group)
            off = 0
            for leaf in bucket:
                n = leaf.shard.numel()
                full = torch.cat([rows[i, off:off + n].view(leaf.shard_shape)
                                  for i in range(self.S)], leaf.zero_dim)
                if leaf.param.numel() == 0:
                    leaf.param.data = full
                else:
                    leaf.param.copy_(full)
                off += n
        self._mark_written()

    def _mark_written(self):
        """Note each ZeRO parameter as the layout last wrote it."""
        for leaf in self.leaves:
            if leaf.shard is not None:
                leaf.written = (leaf.param.data_ptr(), leaf.param._version)

    @torch.no_grad()
    def refresh_shards(self):
        """Copy the slice of each whole parameter set from outside since
        the layout last wrote it (a `set_state_dict`, a `copy_`, a new
        `.data`) into its shard; the others are the shards' own."""
        for leaf in self.leaves:
            if leaf.shard is not None and leaf.param.numel() and \
                    leaf.written != (leaf.param.data_ptr(),
                                     leaf.param._version):
                leaf.shard.copy_(self._own(leaf.param.detach(), leaf))
                leaf.written = (leaf.param.data_ptr(), leaf.param._version)

    def release_params(self):
        """Stage 3: drop the whole parameters' storage between steps."""
        for leaf in self.leaves:
            if leaf.shard is not None:
                leaf.param.data = leaf.param.data.new_empty(0)

    def before_forward(self):
        if self.zero_stage >= 3:
            self.gather_params()
        else:
            self.refresh_shards()

    def after_update(self):
        if self.zero_stage >= 3:
            self.release_params()
        else:
            self.gather_params()

    # ---- the logical state ----
    @torch.no_grad()
    def full_state(self, model):
        """The model's state_dict with every parameter whole: ZeRO shards
        gathered over sharding, model shards over model (the JAX step's
        logical `state_dict()`), on every rank."""
        released = self.zero_stage >= 3
        if released:
            self.gather_params()
        out = model.state_dict()
        for k, p in model.named_parameters():
            dim = _dim_of(_param_spec(p, self.mesh), "model")
            if dim is not None and k in out:
                out[k] = C.all_gather_concat(p.detach().contiguous(),
                                             self.mp_group, concat_axis=dim)
            elif k in out:
                out[k] = p.detach().clone()
        if released:
            self.release_params()
        return out
