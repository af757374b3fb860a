"""Collective communication (counterpart of paddle_tpu/distributed/collective.py).

One process a rank, over `torch.distributed`. A `Group` wraps a torch
`ProcessGroup` (None: the world). A group of one rank inside a larger
world (a hybrid subgroup of degree 1, or a group built without a process
group) makes every collective the identity, as in the JAX package's
single process; a world of one rank runs them through its backend, so a
one-rank NCCL group exercises NCCL. `src`
and `dst` are global ranks; where a group is given and `src` is not one
of its ranks it is read as an index into the group, as the JAX
`broadcast` does.

The JAX module runs its collectives as `lax` primitives inside a
`shard_map` over mesh axes. `axis_context`, `in_axis_context`,
`current_axes` and `ppermute_to` belong to that model and are not ported:
here a group is a process group, and the train step (`parallel/api.py`)
and the tensor-parallel layers call the collectives over the hybrid
group's subgroups (`topology.py`) directly; a permutation of the pipeline
is the pipeline slice's (ROADMAP §1 item 8b).

Semantics beside the JAX ones:
- `reduce` leaves the result on `dst` only (torch's), where the JAX one
  leaves it on every rank;
- `send` / `recv` are one-sided point-to-point transfers; the JAX pair is
  one `ppermute`;
- AVG is a SUM divided by the group's size on every backend, as `pmean`.

On one card every rank shares the GPU, so the ranks talk over gloo
(`parallel_env.choose_backend`). Gloo takes every collective here on
CUDA tensors in fp32, bf16 and fp16 except `send` and `recv`, whose CUDA
path aborts the process, and the list form of `all_to_all`, which it
refuses (torch 2.11 on an H100: `tools/probe_gloo_cuda.py`). So `alltoall`
runs through `all_to_all_single`, and `_host_staged` copies the
point-to-point tensors through host memory for gloo. Sums keep the
tensor's dtype on the wire (a bf16 sum is a bf16 sum), as NCCL's do.

Every collective adds the bytes this rank hands it to `comm_bytes()`
(by op), and with `comm_timing(True)` the host seconds it takes, after a
device synchronize, to `comm_seconds()`: what a step moves, and the
share of its time the collectives take.

The tensor-parallel operators are `torch.autograd.Function`s over the
model-parallel group:
- `_c_identity`: forward identity, backward all-reduce;
- `_mp_allreduce`: forward all-reduce, backward identity;
- `_c_concat`: forward all-gather on the last dim, backward the rank's
  own slice;
- `_c_split`: forward the rank's own slice of the last dim, backward
  all-gather;
- `_c_softmax_with_cross_entropy`: the vocab-sharded softmax CE, its
  global max and sum over the group, with the JAX analytic backward.
The first two and the CE have the JAX custom_vjp's rules. The JAX
`_c_concat` and `_c_split` take the AD transposes of `all_gather` and of
a slice inside `shard_map` (a reduce-scatter, and the slice padded with
zeros); those are right for a loss summed over ranks, where every rank of
this port holds the one replicated loss whole, so the port takes the
Megatron rules, which give the same gradient as the JAX operator under a
replicated `shard_map` output (`tests/test_torch_collective.py`).
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from .parallel_env import get_rank, get_world_size


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communication group: its global `ranks`, this process's index in
    them (`rank`, -1 outside), and the torch `ProcessGroup` (None for
    the world, or for a bookkeeping group of a topology built without a
    process group)."""

    def __init__(self, rank: int, nranks: int, id: int = 0,
                 ranks: Optional[List[int]] = None, pg=None,
                 name: Optional[str] = None):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.ranks = list(ranks) if ranks is not None else list(
            range(nranks))
        self.process_group = pg
        self.name = name

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    def __repr__(self):
        return (f"Group(rank={self.rank}, nranks={self.nranks}, "
                f"ranks={self.ranks}, name={self.name})")


_GROUPS = {}
_COMM = {"bytes": {}, "seconds": {}, "timing": False}


def comm_bytes() -> dict:
    """{op: bytes this rank handed to it} since the last reset."""
    return dict(_COMM["bytes"])


def comm_seconds() -> dict:
    """{op: host seconds inside it} while comm_timing was on."""
    return dict(_COMM["seconds"])


def reset_comm_counts():
    _COMM["bytes"].clear()
    _COMM["seconds"].clear()


def comm_timing(on: bool):
    """Time each collective on the host clock after a device synchronize
    (so the time is the collective's own, not the kernels' before it)."""
    _COMM["timing"] = bool(on)


@contextlib.contextmanager
def _counted(op, *tensors):
    b = _COMM["bytes"]
    b[op] = b.get(op, 0) + sum(t.numel() * t.element_size()
                               for t in tensors)
    if not _COMM["timing"]:
        yield
        return
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    sec = _COMM["seconds"]
    sec[op] = sec.get(op, 0.0) + time.perf_counter() - t0


def get_default_group() -> Group:
    """The world as a Group (its process group: torch's default)."""
    return Group(get_rank(), get_world_size(), 0)


def get_group(id=0):
    return get_default_group() if id == 0 else _GROUPS.get(id)


def new_group(ranks=None, backend=None, name=None) -> Group:
    """A group over the global `ranks` (all by default). Every rank of
    the world must call it, in the same order (torch's `new_group`)."""
    world = get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    me = get_rank()
    pg = None
    if dist.is_initialized() and len(ranks) < world:
        pg = dist.new_group(ranks, backend=backend)
    gid = max(_GROUPS, default=0) + 1
    g = Group(ranks.index(me) if me in ranks else -1, len(ranks), gid,
              ranks, pg, name)
    _GROUPS[gid] = g
    return g


def _group(group) -> Group:
    return get_default_group() if group is None else group


def _trivial(g: Group) -> bool:
    """A group of one rank inside a larger world, or with no process
    group running: its collectives are the identity."""
    return g.nranks == 1 and not (dist.is_initialized()
                                  and dist.get_world_size() == 1)


def _pg(g: Group):
    """The torch process group of `g` (None = the world); raises for a
    bookkeeping group over several ranks."""
    if g.process_group is None and g.nranks > 1 and (
            not dist.is_initialized() or g.nranks != dist.get_world_size()):
        raise RuntimeError(f"{g!r} has no process group: start one first "
                           "(init_parallel_env or fleet.init)")
    return g.process_group


def _global(g: Group, r: int) -> int:
    """A src/dst rank: global when it is one of the group's ranks, else
    an index into the group (the JAX rule)."""
    return r if r in g.ranks else g.ranks[r]


def _host_staged(t: torch.Tensor, g: Group) -> bool:
    """Whether a point-to-point transfer of `t` crosses through host
    memory: gloo aborts on the device pointer of a CUDA tensor."""
    return t.is_cuda and dist.get_backend(_pg(g)) == "gloo"


# ---- collectives ----

def all_reduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True,
               sync_op=True):
    """Reduce `tensor` over the group in place and return it."""
    g = _group(group)
    if _trivial(g):
        return tensor
    with _counted("all_reduce", tensor):
        dist.all_reduce(tensor, op=_TORCH_OP[op], group=_pg(g))
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, use_calc_stream=True):
    """Reduce onto global rank `dst` (only there is `tensor` the result)."""
    g = _group(group)
    if _trivial(g):
        return tensor
    with _counted("reduce", tensor):
        dist.reduce(tensor, _global(g, dst), op=_TORCH_OP[op],
                    group=_pg(g))
    if op == ReduceOp.AVG and get_rank() == _global(g, dst):
        tensor.div_(g.nranks)
    return tensor


def all_gather(tensor_list, tensor, group=None, use_calc_stream=True,
               axis=0):
    """Every rank's `tensor`, in group order: into `tensor_list` (a list,
    cleared) and stacked on a new dim 0 as the return value."""
    g = _group(group)
    if _trivial(g):
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
        with _counted("all_gather", tensor):
            dist.all_gather(parts, tensor.contiguous(), group=_pg(g))
    if isinstance(tensor_list, list):
        tensor_list.clear()
        tensor_list.extend(parts)
    return torch.stack(parts)


def all_gather_concat(tensor, group=None, concat_axis=0):
    """Every rank's `tensor` concatenated along `concat_axis`."""
    g = _group(group)
    if _trivial(g):
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
    with _counted("all_gather", tensor):
        dist.all_gather(parts, tensor.contiguous(), group=_pg(g))
    return torch.cat(parts, concat_axis)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the n pieces (a list, or one tensor split on dim 0) over
    the group; rank i's `tensor` gets the reduced piece i."""
    g = _group(group)
    src = tensor_or_tensor_list
    if not isinstance(src, (list, tuple)):
        src = list(src.chunk(g.nranks, 0))
    if _trivial(g):
        with torch.no_grad():
            tensor.copy_(src[0])
        return tensor
    with _counted("reduce_scatter", *src):
        dist.reduce_scatter(tensor, [s.contiguous() for s in src],
                            op=_TORCH_OP[op], group=_pg(g))
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def all_to_all_single(tensor, group=None, split_axis=0, concat_axis=0):
    """Split `tensor` into n chunks along `split_axis`; chunk i goes to
    rank i, and what arrives is concatenated along `concat_axis` in rank
    order (the JAX tiled `all_to_all`)."""
    g = _group(group)
    if _trivial(g):
        return tensor
    chunks = tensor.chunk(g.nranks, split_axis)
    send = torch.stack([c.contiguous() for c in chunks])
    recv = torch.empty_like(send)
    with _counted("all_to_all", send):
        dist.all_to_all_single(recv, send, group=_pg(g))
    return torch.cat(list(recv.unbind(0)), concat_axis)


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             use_calc_stream=True):
    """`in_tensor_list[i]` goes to rank i; returns what arrived stacked in
    rank order (and fills `out_tensor_list`). A tensor is read as the
    list of its dim-0 slices. Runs through `all_to_all_single` (gloo has
    no list form)."""
    g = _group(group)
    stacked = (torch.stack(list(in_tensor_list))
               if isinstance(in_tensor_list, (list, tuple))
               else in_tensor_list)
    if _trivial(g):
        out = stacked
    else:
        out = torch.empty_like(stacked)
        with _counted("all_to_all", stacked):
            dist.all_to_all_single(out, stacked.contiguous(),
                                   group=_pg(g))
    if isinstance(out_tensor_list, list):
        out_tensor_list.clear()
        out_tensor_list.extend(out.unbind(0))
    return out


def broadcast(tensor, src, group=None, use_calc_stream=True):
    """`src`'s tensor onto every rank, in place."""
    g = _group(group)
    if _trivial(g):
        return tensor
    with _counted("broadcast", tensor):
        dist.broadcast(tensor, _global(g, src), group=_pg(g))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None,
            use_calc_stream=True):
    """Rank i's `tensor` := `src`'s `tensor_list[i]`."""
    g = _group(group)
    if _trivial(g):
        if tensor_list:
            with torch.no_grad():
                tensor.copy_(tensor_list[0])
        return tensor
    s = _global(g, src)
    with _counted("scatter", tensor):
        dist.scatter(tensor, [t.contiguous() for t in tensor_list]
                     if get_rank() == s else None, src=s, group=_pg(g))
    return tensor


def send(tensor, dst=0, group=None, use_calc_stream=True):
    g = _group(group)
    t = tensor.cpu() if _host_staged(tensor, g) else tensor
    with _counted("send", tensor):
        dist.send(t.contiguous(), _global(g, dst), group=_pg(g))
    return tensor


def recv(tensor, src=0, group=None, use_calc_stream=True):
    g = _group(group)
    if _host_staged(tensor, g):
        buf = torch.empty(tensor.shape, dtype=tensor.dtype)
        dist.recv(buf, _global(g, src), group=_pg(g))
        tensor.copy_(buf)
    else:
        dist.recv(tensor, _global(g, src), group=_pg(g))
    return tensor


def barrier(group=None):
    g = _group(group)
    if not _trivial(g):
        dist.barrier(group=_pg(g))


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the device has finished `tensor` (the JAX
    block_until_ready)."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def destroy_process_group(group=None):
    """Tear down `group`'s process group, or (None) every group and the
    world's."""
    if group is not None:
        if group.process_group is not None:
            dist.destroy_process_group(group.process_group)
        _GROUPS.pop(group.id, None)
        return
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    from .parallel_env import _STATE
    _STATE.update(device=None, backend=None)


# ---- flat buckets: one collective for many tensors ----

BUCKET_MB = 64      # the bytes a bucket holds before it closes, in MiB


def buckets(tensors, bucket_mb=BUCKET_MB) -> List[List[int]]:
    """The indices of `tensors` in buckets, in order: one dtype a bucket,
    each closed once it holds `bucket_mb` MiB or more (numel x element
    size), as the JAX `_bucket_grads` fills them."""
    cap = max(int(bucket_mb * 2 ** 20), 1)
    by = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.dtype, []).append(i)
    out = []
    for idx in by.values():
        cur, size = [], 0
        for i in idx:
            cur.append(i)
            size += tensors[i].numel() * tensors[i].element_size()
            if size >= cap:
                out.append(cur)
                cur, size = [], 0
        if cur:
            out.append(cur)
    return out


@torch.no_grad()
def flat_apply(tensors, fn, bucket_mb=BUCKET_MB):
    """fn(flat) on each bucket of `tensors` concatenated flat, then each
    tensor written back from it in place: one collective a bucket where
    `fn` runs one."""
    for b in buckets(tensors, bucket_mb):
        ts = [tensors[i] for i in b]
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def sum_over(tensors, groups, scale=1.0, bucket_mb=BUCKET_MB):
    """Each tensor in place: its sum over every group of `groups` (a
    group after the other, one all-reduce a bucket and group), times
    `scale`."""
    groups = [g for g in groups if g.nranks > 1]
    if not groups and scale == 1.0:
        return

    def fn(flat):
        for g in groups:
            all_reduce(flat, group=g)
        if scale != 1.0:
            flat.mul_(scale)
    flat_apply(tensors, fn, bucket_mb)


def average_over(tensors, groups, bucket_mb=BUCKET_MB):
    """Each tensor in place: its mean over the ranks of `groups` together
    (the batch ranks of a data x sharding layout)."""
    n = 1
    for g in groups:
        n *= g.nranks
    sum_over(tensors, groups, 1.0 / n, bucket_mb)


# ---- tensor-parallel operators ----

def _own_slice(t, g: Group):
    piece = t.shape[-1] // g.nranks
    return t[..., g.rank * piece:(g.rank + 1) * piece].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), group=ctx.g), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, op):
        return all_reduce(x.contiguous().clone(), op, group=g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_gather_concat(x, g, concat_axis=x.ndim - 1)

    @staticmethod
    def backward(ctx, dy):
        return _own_slice(dy, ctx.g), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _own_slice(x, g)

    @staticmethod
    def backward(ctx, dy):
        return all_gather_concat(dy, ctx.g, concat_axis=dy.ndim - 1), None


def _c_identity(tensor, group=None):
    """Forward identity, backward all-reduce (a column-parallel input)."""
    g = _group(group)
    return tensor if g.nranks == 1 else _Identity.apply(tensor, g)


def _mp_allreduce(tensor, op=ReduceOp.SUM, group=None):
    """Forward all-reduce, backward identity (a row-parallel output)."""
    g = _group(group)
    return tensor if g.nranks == 1 else _AllReduce.apply(tensor, g, op)


def _c_concat(tensor, group=None):
    """All-gather along the last dim (a column-parallel gather_output)."""
    g = _group(group)
    return tensor if g.nranks == 1 else _Concat.apply(tensor, g)


def _c_split(tensor, group=None):
    """This rank's slice of the last dim (a row-parallel input)."""
    g = _group(group)
    return tensor if g.nranks == 1 else _Split.apply(tensor, g)


class _VocabParallelCE(torch.autograd.Function):
    """The JAX `_c_softmax_with_cross_entropy` over the group: logits
    [..., V/n] sharded on the class dim, the label global; fp32 math;
    loss 0 where the label is `ignore_index`."""

    @staticmethod
    def forward(ctx, logits, label, g, ignore_index):
        n_shard = logits.shape[-1]
        a32 = logits.float()
        gmax = all_reduce(a32.amax(-1, keepdim=True), ReduceOp.MAX, g)
        sumexp = all_reduce((a32 - gmax).exp().sum(-1, keepdim=True),
                            group=g)
        logz = sumexp.log() + gmax
        squeeze = label.ndim == logits.ndim and label.shape[-1] == 1
        yy = (label[..., 0] if squeeze else label).long()
        local = yy - g.rank * n_shard
        in_range = (local >= 0) & (local < n_shard)
        safe = local.clamp(0, n_shard - 1)
        picked = a32.gather(-1, safe[..., None])[..., 0]
        target = all_reduce(torch.where(in_range, picked, 0.0), group=g)
        loss = logz[..., 0] - target
        loss = torch.where(yy == ignore_index, 0.0, loss)
        ctx.save_for_backward(logits, logz, safe, in_range, yy)
        ctx.ignore_index = ignore_index
        ctx.squeeze = squeeze
        return loss[..., None] if squeeze else loss

    @staticmethod
    def backward(ctx, dy):
        a, logz, safe, in_range, yy = ctx.saved_tensors
        gg = dy[..., 0] if ctx.squeeze else dy
        gg = torch.where(yy == ctx.ignore_index, 0.0, gg).float()
        p = (a.float() - logz).exp()
        da = p * gg[..., None]
        sub = torch.where(in_range, gg, 0.0)
        da = da - torch.nn.functional.one_hot(
            safe, a.shape[-1]).float() * sub[..., None]
        return da.to(a.dtype), None, None, None


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  ignore_index=-100):
    """Vocab-sharded softmax CE; on a group of one,
    `softmax_with_cross_entropy`."""
    g = _group(group)
    if g.nranks == 1:
        from ..nn.functional.loss import softmax_with_cross_entropy
        return softmax_with_cross_entropy(logits, label,
                                          ignore_index=ignore_index)
    return _VocabParallelCE.apply(logits, label, g, ignore_index)
