"""Mixture of experts at one device (counterpart of
paddle_tpu/nn/layer/moe.py): a softmax router, top-k routing with a
capacity per expert, stacked experts and the Switch load-balancing loss.

The JAX package routes in the dense GShard form: `dispatch` and `combine`
are [T, E, C] tensors and tokens move by two einsums (moe.py:26-90).
Here the same function is computed by index. `top_k_route` returns, for
each (token, rank), its expert, its slot in that expert's queue and
whether it was kept, with the normalised combine weights [T, k]; kept
tokens are copied into an [E, C, H] buffer, the experts run as batched
products over it (`torch.bmm`), and each token takes the weighted sum of
its k rows back. Dispatch is one-hot, so the copy is exact, and combine
sums k terms instead of E·C, which only reorders the sum. No [T, E, C]
tensor is built; `dense_dispatch_combine` expands the index form to
JAX's two tensors for the tests.

Numerics follow the JAX function: the router runs in fp32 whatever x's
dtype; slots come from a cumulative count over tokens in order, offset by
the slots earlier ranks filled; the weights are divided by max(sum of the
kept gate values, 1e-9), so a token with every choice dropped gets a zero
output; the aux loss takes the top-1 choice before any drop and the full
softmax; the weights and biases are cast to x's dtype before use. Nothing
here goes through the port's autocast hooks (JAX's MoE calls raw jnp), so
under AMP O1 the experts run in the dtype of their fp32 input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Layer, create_parameter

ACTIVATIONS = {"gelu": lambda a: F.gelu(a, approximate="tanh"),
               "relu": F.relu, "silu": F.silu}


def capacity_of(tokens: int, top_k: int, num_experts: int,
                capacity_factor: float) -> int:
    """Slots an expert holds for `tokens` tokens (JAX's formula)."""
    return max(int(capacity_factor * tokens * top_k / num_experts), top_k)


def _count_down_tokens(mask):
    """mask.cumsum(0) of an int [T, E] one-hot: each expert's running
    count of tokens, in token order. Taken as one flat scan of the
    expert-major copy minus each expert's count before its row (exact
    integers): a scan down T of only E columns is one serial chain of T
    steps a column on a GPU."""
    E, T = mask.shape[1], mask.shape[0]
    by_expert = mask.t().reshape(-1)
    running = by_expert.cumsum(0).view(E, T)
    before = running[:, :1] - by_expert.view(E, T)[:, :1]
    return (running - before).t()


def top_k_route(gates: torch.Tensor, capacity: int, top_k: int):
    """Routing of fp32 gates [T, E] (the JAX `_top_k_dispatch`'s function
    in index form): (expert [T, k] int64, slot [T, k] int64, kept [T, k]
    bool, weight [T, k] fp32, aux 0-d fp32). `slot` is the position in
    the expert's queue, kept iff it is below `capacity`; `weight` is 0
    where a pair was dropped. All on the gates' device, with no host
    sync."""
    T, E = gates.shape
    remaining = gates
    fill = torch.zeros((E,), dtype=torch.int64, device=gates.device)
    experts, slots, kepts, vals = [], [], [], []
    mask1 = None
    for rank in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                 # [T]
        mask = F.one_hot(idx, E)                              # [T, E]
        if rank == 0:
            mask1 = mask
        pos = (_count_down_tokens(mask) - 1 + fill).gather(
            1, idx[:, None])[:, 0]
        keep = pos < capacity
        fill = fill + (mask * keep[:, None]).sum(0)
        remaining = remaining * (1 - mask).to(remaining.dtype)
        experts.append(idx)
        slots.append(pos)
        kepts.append(keep)
        vals.append(gates.gather(1, idx[:, None])[:, 0])
    expert = torch.stack(experts, 1)
    kept = torch.stack(kepts, 1)
    kept_vals = torch.where(kept, torch.stack(vals, 1), 0.0)
    denom = kept_vals.sum(1, keepdim=True).clamp_min(1e-9)
    # load balance: E * sum_e (share of tokens whose top-1 is e) * (mean
    # gate probability of e)
    density = mask1.float().mean(0)
    aux = E * (density * gates.mean(0)).sum()
    return expert, torch.stack(slots, 1), kept, kept_vals / denom, aux


def dense_dispatch_combine(expert, slot, kept, weight, num_experts,
                           capacity):
    """The JAX package's dense `dispatch` and `combine` [T, E, C] (fp32)
    built from the index form: for tests, never on the model's path."""
    T, k = expert.shape
    dispatch = torch.zeros((T, num_experts, capacity), dtype=torch.float32,
                           device=expert.device)
    combine = torch.zeros_like(dispatch)
    for r in range(k):
        t = torch.nonzero(kept[:, r])[:, 0]
        e, c = expert[t, r], slot[t, r]
        dispatch[t, e, c] += 1.0
        combine[t, e, c] += weight[t, r]
    return dispatch, combine


def _route(xt, gate_w, top_k, capacity):
    """The router: fp32 gates [T, E] = softmax(x · gate_w), and their
    top_k_route."""
    gates = torch.softmax(xt.float() @ gate_w.float(), dim=-1)
    return (gates,) + top_k_route(gates, capacity, top_k)


def _dispatch(xt, expert, slot, kept, num_experts, capacity):
    """Copy each kept (token, rank) pair's row of xt [T, H] into row
    e·C + slot of the expert buffer [E, C, H] (empty slots stay 0).
    Returns (buffer, each pair's row, or E·C where it was dropped)."""
    T, H = xt.shape
    k = expert.shape[1]
    EC = num_experts * capacity
    flat = torch.where(kept, expert * capacity + slot, EC).reshape(-1)
    rows = xt[:, None, :].expand(T, k, H).reshape(T * k, H)
    # a dropped pair lands in a scratch row past the end
    buf = xt.new_zeros((EC + 1, H)).index_copy(0, flat, rows)
    return buf[:EC].view(num_experts, capacity, H), flat


def _experts(expert_in, w1, b1, w2, b2, activation):
    """The stacked experts over their buffers [E, C, H]: act(x · w1 + b1)
    · w2 + b2 as batched products, biases cast to x's dtype; [E·C, H]."""
    dt = expert_in.dtype
    h = activation(torch.bmm(expert_in, w1) + b1[:, None, :].to(dt))
    out = torch.bmm(h, w2) + b2[:, None, :].to(dt)
    return out.view(-1, out.shape[-1])


def _combine(expert_out, flat, kept, weight):
    """Each token's k rows of expert_out [E·C, H], weighted and summed in
    fp32 (the weights cast to the rows' dtype first, as JAX's
    combine.astype); a dropped pair reads row 0 with weight 0. [T, H] in
    expert_out's dtype."""
    T, k = weight.shape
    H = expert_out.shape[-1]
    dt = expert_out.dtype
    picked = expert_out.index_select(0, torch.where(kept.reshape(-1), flat,
                                                    0))
    w = weight.to(dt).float().reshape(T * k, 1)
    return (picked.float() * w).view(T, k, H).sum(1).to(dt)


def moe_forward(x, gate_w, w1, b1, w2, b2, top_k, capacity_factor,
                activation=ACTIVATIONS["gelu"], return_routing=False):
    """MoE over tensors: x [B, S, H], gate_w [H, E], w1 [E, H, F], b1
    [E, F], w2 [E, F, H], b2 [E, H]. Returns (out [B, S, H] in x's dtype,
    aux 0-d fp32), and the routing (expert, slot, kept, gates) with
    `return_routing`."""
    B, S, H = x.shape
    E = w1.shape[0]
    xt = x.reshape(B * S, H)
    C = capacity_of(B * S, top_k, E, capacity_factor)
    gates, expert, slot, kept, weight, aux = _route(xt, gate_w, top_k, C)
    expert_in, flat = _dispatch(xt, expert, slot, kept, E, C)
    expert_out = _experts(expert_in, w1, b1, w2, b2, activation)
    out = _combine(expert_out, flat, kept, weight).view(B, S, H)
    if return_routing:
        return out, aux, (expert, slot, kept, gates)
    return out, aux


def moe_forward_ep(*args, **kwargs):
    """Expert parallelism (experts sharded over ranks, tokens exchanged
    by all_to_all) needs several GPUs."""
    raise NotImplementedError(
        "moe_forward_ep: expert parallelism needs several ranks "
        "(ROADMAP §1 item 8)")


def _xavier_uniform_(w, generator):
    """XavierUniform with the JAX package's fans (initializer._fans): a
    2-D [in, out] weight has fan_in = in, fan_out = out; a 3-D expert
    stack [E, a, b] has fan_in = a·b, fan_out = E·b."""
    if w.dim() == 2:
        fan_in, fan_out = w.shape[0], w.shape[1]
    else:
        rf = math.prod(w.shape[2:])
        fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-limit, limit, generator=generator)


class MoELayer(Layer):
    """paddle.incubate-style MoE FFN: a gate and stacked experts.

    usage:
        moe = MoELayer(d_model=512, d_hidden=2048, num_experts=8, top_k=2)
        out = moe(x)               # x: [B, S, d_model]
        aux = moe.aux_loss         # add to the training loss (scaled)

    `routing` holds the last forward's (expert, slot, kept, gates),
    detached, for inspection. `gate` and `name` are taken and not read,
    as in the JAX layer."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu", gate=None,
                 name=None, device=None, dtype=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self._act = ACTIVATIONS[activation]
        self.gate_weight = create_parameter([d_model, num_experts], device,
                                            dtype)
        self.w1 = create_parameter([num_experts, d_model, d_hidden], device,
                                   dtype)
        self.b1 = create_parameter([num_experts, d_hidden], device, dtype)
        self.w2 = create_parameter([num_experts, d_hidden, d_model], device,
                                   dtype)
        self.b2 = create_parameter([num_experts, d_model], device, dtype)
        self.aux_loss = None
        self.routing = None

    def reset_parameters(self, generator=None):
        for w in (self.gate_weight, self.w1, self.w2):
            _xavier_uniform_(w, generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x):
        out, aux, routing = moe_forward(
            x, self.gate_weight, self.w1, self.b1, self.w2, self.b2,
            self.top_k, self.capacity_factor, self._act, return_routing=True)
        self.aux_loss = aux
        self.routing = tuple(t.detach() for t in routing)
        return out

    def extra_repr(self):
        return (f"experts={self.num_experts}, top_k={self.top_k}, "
                f"capacity_factor={self.capacity_factor}")
