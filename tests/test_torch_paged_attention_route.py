"""The two promises the tensor-core paged-attention kernel rests on, checked
on the CPU through the plain version and the route helper.

- The causal horizon cut is exact: the kernel walks a query tile's blocks
  only up to n_active = min(ceil(len / bl), ceil((q_pos + t_max + 1) /
  bl)), t_max the tile's largest query position
  (csrc/paged_attention_tc.cu). Every later block is fully masked for the
  tile's rows, and a fully masked block leaves (m, l, acc) bit-unchanged,
  so the plain version walking the table cut there gives the tile's rows
  bit for bit what the full walk gives.
- The route: `paged_route` mirrors the rule in `pdtt_paged_attention`
  (csrc/paged_attention.cu): bf16 at a block_len that is a multiple of 8
  and a head dim of 64 or 128 takes the tensor cores, everything else the
  scalar kernel. (On the card, tests/test_torch_cuda_kernels.py checks the
  kernels a call really launches against it.)
"""
import pytest
import torch

from _torch_port import paged_inputs


def _horizon_blocks(seq_len, q_pos, t_max, block_len):
    """The kernel's walk length for a tile whose largest query position
    is t_max."""
    horizon = q_pos + t_max + 1
    n = -(-max(seq_len, 0) // block_len)
    return min(n, -(-horizon // block_len) if horizon > 0 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bl,lens,Tq,decode_rows,tiles", [
    (8, (37, 9, 20), 16, (1,), ((0, 5), (5, 11), (11, 16))),
    (16, (70, 33, 1), 24, (), ((0, 1), (0, 12), (12, 24))),
    (24, (50, 44, 7), 9, (0, 2), ((0, 9), (3, 4))),
    (64, (64, 100, 3), 30, (1,), ((0, 30), (10, 17))),
])
def test_plain_cut_at_causal_horizon_equals_full_walk(dtype, bl, lens, Tq,
                                                      decode_rows, tiles):
    from paddle_tpu_torch.ops.paged_attention import paged_attention_plain
    c = paged_inputs(31, H=4, Hkv=2, Tq=Tq, D=16, bl=bl, ppr=5, lens=lens,
                     decode_rows=decode_rows)
    t = lambda a: torch.from_numpy(a).to(dtype)     # noqa: E731
    q, k, v = t(c["q"]), t(c["k"]), t(c["v"])
    table = torch.from_numpy(c["table"])
    scale = 16 ** -0.5
    cut_any = False
    for b in range(len(lens)):
        # one batch row at a time: the kernel's walk length is per row
        args = (q[b:b + 1], k, v)
        side = (torch.from_numpy(c["lens"][b:b + 1]),
                torch.from_numpy(c["q_pos"][b:b + 1]), bl, c["ppr"], scale)
        full = paged_attention_plain(*args, table[b:b + 1], *side)
        for t0, t1 in tiles:
            n = _horizon_blocks(int(c["lens"][b]), int(c["q_pos"][b]),
                                t1 - 1, bl)
            cut_any |= n < table.shape[1]
            cut = paged_attention_plain(*args, table[b:b + 1, :n], *side)
            assert torch.equal(cut[:, :, t0:t1], full[:, :, t0:t1]), \
                (b, t0, t1, n)
    assert cut_any      # the cases do cut blocks off the walk


def test_horizon_cut_changes_rows_past_the_tile():
    """The cut is exact only for the tile's own rows: a later row that sees
    past the horizon does change, so the test above is not vacuous."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention_plain
    c = paged_inputs(32, H=2, Hkv=2, Tq=16, D=16, bl=8, lens=(40, 40, 40),
                     decode_rows=())
    f = torch.from_numpy
    table = f(c["table"])[:1]
    side = (f(c["lens"][:1]), f(c["q_pos"][:1]), 8, c["ppr"], 0.25)
    args = (f(c["q"][:1]), f(c["k"]), f(c["v"]))
    full = paged_attention_plain(*args, table, *side)
    n = _horizon_blocks(40, int(c["q_pos"][0]), 3, 8)      # tile rows 0..3
    cut = paged_attention_plain(*args, table[:, :n], *side)
    assert torch.equal(cut[:, :, :4], full[:, :, :4])
    assert not torch.equal(cut[:, :, 4:], full[:, :, 4:])


@pytest.mark.parametrize("dtype,block_len,head_dim,route", [
    (torch.bfloat16, 8, 128, "tensor_cores"),
    (torch.bfloat16, 8, 64, "tensor_cores"),
    (torch.bfloat16, 16, 128, "tensor_cores"),
    (torch.bfloat16, 24, 64, "tensor_cores"),
    (torch.bfloat16, 64, 128, "tensor_cores"),
    (torch.bfloat16, 4, 128, "scalar"),
    (torch.bfloat16, 12, 128, "scalar"),
    (torch.bfloat16, 1, 64, "scalar"),
    (torch.bfloat16, 8, 32, "scalar"),
    (torch.float32, 8, 128, "scalar"),
    (torch.float32, 16, 64, "scalar"),
    (torch.float16, 8, 128, "tensor_cores"),
    (torch.float16, 64, 64, "tensor_cores"),
    (torch.float16, 12, 128, "scalar"),
    (torch.float16, 8, 32, "scalar"),
])
def test_paged_route_rule(dtype, block_len, head_dim, route):
    from paddle_tpu_torch.ops.paged_attention import paged_route
    assert paged_route(dtype, block_len, head_dim) == route
