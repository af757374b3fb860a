"""The PyTorch port's CUDA kernels against their plain versions, on a GPU.

These tests need an NVIDIA GPU and skip without one; they import no JAX,
so they also run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(`--noconftest`: the suite's conftest pins JAX to the CPU.) Inputs are
drawn with numpy from a seed, as in the CPU parity tests; tolerances:
fp32 atol/rtol 1e-5 (same op sequence, sums in another order); bf16
paged attention the limits `chip_smoke.py` states and explains (a few
bf16 ulps of each element, and a ceiling on the share past one ulp); bf16
LayerNorm one bf16 ulp of the output + 1e-5 (both round one fp32 value
once; near y = 0 the fp32 difference itself survives). The LayerNorm
forward is also held bit-equal across runs, for a row alone against the
same row among 64 or 512, and at scalar width (a view at an odd offset)
against 16-byte width. The training
kernels (flash attention forward, dq, dk/dv; LayerNorm backward): fp32
atol/rtol 1e-5 for outputs of one op sequence, 1e-4 for sums of many
products in another order; bf16 within `chip_smoke.py`'s
BF16_TRAIN_FACTOR times the bf16 plain version's own error from the fp32
plain version, plus BF16_TRAIN_ATOL. Their sums run in a fixed order, so
two runs are bit-equal, which is tested too (forward and backward, and
bf16 paged attention). The bf16 flash forward, dq and dk/dv run on the
tensor cores (their machine code holds wgmma's HGMMA instructions), and
so does bf16 paged attention at a block_len that is a multiple of 8
(mma.sync's HMMA); the profiler's kernel names show that such calls never
reach the scalar kernels, and a bf16 input they cannot take raises
instead of going anywhere else. The mask and dropout variants of the
flash kernels are held the same way, and the keep-mask the kernels draw
equals the plain twin's bit for bit. Fused Adam: bit for bit
(tolerance 0) against its plain version on the card, in every dtype, with
and without a master weight, at ragged, tiny and misaligned n. The fp16
instantiations (AMP in float16, pure-fp16 O2 training, fp16 serving) of
the flash kernels and their variants, LayerNorm and fused Adam follow the
fp16 forms of those rules (chip_smoke.py's FP16_TRAIN_* rule; bit for
bit), fp16 paged attention its FP16_PA_* limits; each counts under its
own `_fp16` launch counter. ResNet-18
at 8 x 3 x 64 x 64 (cuDNN convolutions, BatchNorm and pools, fused Adam)
against its CPU twin under the limits `chip_smoke.py` states for its
resnet_model phase, and the bf16 BatchNorm within one bf16 ulp of fp32
math on its inputs.
"""
import pytest
import torch

from _torch_port import assert_bf16_attention_close, \
    assert_fp16_attention_close, layernorm_inputs, paged_inputs, \
    require_cuda, ulp_bf16


# the served kind of lengths (tens to hundreds of keys a row), in slabs of
# 40 pages a row
_SERVED = dict(lens=(300, 97, 150), ppr=40)
# llama2-70b's head layout behind the serve cells' engine: 8 slots of 64
# pages at block_len 8, 64 query heads over 8 kv heads (512 rows a kv
# group at Tq = 64, 8 at Tq = 1), ragged served lengths
_LLAMA70 = dict(B=8, N=8, ppr=64, pad=64,
                lens=(512, 37, 200, 1, 448, 64, 300, 129))
_LLAMA70_PREFILL = dict(_LLAMA70, decode_rows=(1, 3, 6))
_LLAMA70_DECODE = dict(_LLAMA70, decode_rows=tuple(range(8)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,D,bl,Tq,more", [
    (torch.float32, 4, 2, 128, 8, 64, {}),
    (torch.float32, 8, 2, 64, 32, 64, {}),
    (torch.bfloat16, 16, 16, 128, 8, 64, {}),
    # the tensor-core route's other instantiations and edges: GQA, D=64,
    # block_len 16..64, Tq past one 64-row tile and Tq = 1
    (torch.bfloat16, 16, 4, 128, 8, 90, _SERVED),
    (torch.bfloat16, 8, 2, 64, 16, 64, {}),
    (torch.bfloat16, 4, 4, 128, 24, 7, {}),
    (torch.bfloat16, 8, 1, 128, 64, 1, {}),
    # bf16 at a block_len the route sends to the scalar kernel
    (torch.bfloat16, 4, 2, 128, 12, 64, {}),
    # llama2-70b's grouped-query layout (n_rep = 8): a prefill chunk and
    # decode rows
    (torch.bfloat16, 64, 8, 128, 8, 64, _LLAMA70_PREFILL),
    (torch.bfloat16, 64, 8, 128, 8, 1, _LLAMA70_DECODE),
])
def test_cuda_paged_attention_matches_plain(dtype, H, Hkv, D, bl, Tq, more):
    require_cuda()
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain,
                                                      ragged_paged_attention)
    c = paged_inputs(21, H=H, Hkv=Hkv, D=D, bl=bl, Tq=Tq, **more)
    t = lambda a: torch.from_numpy(a).to("cuda", dtype)    # noqa: E731
    i = lambda a: torch.from_numpy(a).to("cuda")            # noqa: E731
    args = (t(c["q"]), t(c["k"]), t(c["v"]), i(c["table"]), i(c["lens"]),
            i(c["q_pos"]), c["bl"], c["ppr"], D ** -0.5)
    before = launch_counts()["paged_attention"]
    out = paged_attention_cuda(*args)
    ref = paged_attention_plain(*args)
    # the public entry point launches the kernel for CUDA tensors
    via = ragged_paged_attention(*args[:6], block_len=bl,
                                 pages_per_row=c["ppr"])
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 2
    assert torch.equal(via, out)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert_bf16_attention_close(out.float().cpu().numpy(),
                                    ref.float().cpu().numpy())


# fp16 (fp16 serving): the same routes as bf16, held to chip_smoke.py's
# FP16_PA_* rule (the bf16 one scaled by the ulp), two runs bit-equal,
# counted as paged_attention_fp16 and never as paged_attention
@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D,bl,Tq,more", [
    (16, 16, 128, 8, 64, {}),
    (16, 4, 128, 8, 90, _SERVED),
    (8, 2, 64, 16, 64, {}),
    (8, 1, 128, 64, 1, {}),
    (4, 2, 128, 12, 64, {}),             # the scalar route
    (64, 8, 128, 8, 64, _LLAMA70_PREFILL),
])
def test_cuda_paged_attention_fp16_matches_plain(H, Hkv, D, bl, Tq, more):
    require_cuda()
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain)
    c = paged_inputs(24, H=H, Hkv=Hkv, D=D, bl=bl, Tq=Tq, **more)
    t = lambda a: torch.from_numpy(a).to("cuda", torch.float16)  # noqa
    i = lambda a: torch.from_numpy(a).to("cuda")                 # noqa
    args = (t(c["q"]), t(c["k"]), t(c["v"]), i(c["table"]), i(c["lens"]),
            i(c["q_pos"]), c["bl"], c["ppr"], D ** -0.5)
    before = launch_counts()
    runs = [paged_attention_cuda(*args) for _ in range(2)]
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["paged_attention_fp16"] == before["paged_attention_fp16"] + 2
    assert after["paged_attention"] == before["paged_attention"]
    assert runs[0].dtype == torch.float16 and torch.equal(*runs)
    assert_fp16_attention_close(runs[0].float().cpu().numpy(),
                                ref.float().cpu().numpy())


# Rows that see only a handful of keys (Tq = 90 rows past lengths of 17, 9
# and 4, GQA). The two versions sum s = q . k in another order, so a p
# that lies within an fp32 ulp of a bf16 rounding midpoint can round to
# either neighbour, and the output moves by up to 2^-8 p |v| / l: large
# where l is near 1. The limits above leave a few ulps for that (such rows
# are rare on the served path); here most rows are short, so they are held
# as the training kernels are (chip_smoke.bf16_vs_fp32_plain): the
# kernel's largest error from the plain version run in fp32 on the same
# bf16 inputs is at most BF16_TRAIN_FACTOR times the bf16 plain version's
# own, plus BF16_TRAIN_ATOL. A wrong mask, page or rescale moves outputs
# by their own size and fails.
@pytest.mark.cuda
@pytest.mark.parametrize("bl", [8, 16])
def test_cuda_paged_attention_short_rows_within_plain_error(bl):
    require_cuda()
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain)
    c = paged_inputs(21, H=16, Hkv=4, D=128, bl=bl, Tq=90)
    i = lambda a: torch.from_numpy(a).to("cuda")            # noqa: E731
    side = (i(c["table"]), i(c["lens"]), i(c["q_pos"]), bl, c["ppr"],
            128 ** -0.5)
    bf = [torch.from_numpy(c[n]).to("cuda", torch.bfloat16)
          for n in ("q", "k", "v")]
    out = paged_attention_cuda(*bf, *side)
    ref = paged_attention_plain(*bf, *side)
    ref32 = paged_attention_plain(*(t.float() for t in bf), *side)
    _assert_bf16_train(out, ref, ref32)


# The kernels compute each query row alone, walking the blocks in table
# order, so a row's output does not depend on the chunk (or the q tile) it
# arrives in: chunked prefill equals the whole prompt bit for bit, the
# contract that makes engine streams equal generate(). bf16 takes the
# tensor cores at block_len 8 and 16, with GQA putting four heads' rows
# (and the 90-row tail) into one kv group's tiles.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,bl", [
    (torch.float32, 4, 4, 8),
    (torch.bfloat16, 4, 4, 8),
    (torch.bfloat16, 16, 4, 8),
    (torch.bfloat16, 4, 4, 16),
    (torch.bfloat16, 16, 4, 16),
])
def test_cuda_chunked_prefill_bitwise_equals_whole_prompt(dtype, H, Hkv, bl):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops.paged_attention import paged_attention_cuda
    rng = np.random.RandomState(8)
    D, L, C = 128, 90, 64
    nb = -(-96 // bl)
    k, v = (torch.from_numpy(rng.standard_normal((1, Hkv, nb * bl, D))
                             .astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((1, H, L, D))
                         .astype(np.float32)).to("cuda", dtype)
    table = torch.arange(nb, dtype=torch.int32, device="cuda")[None]
    i32 = dict(dtype=torch.int32, device="cuda")
    whole = paged_attention_cuda(q, k, v, table, torch.tensor([L], **i32),
                                 torch.tensor([0], **i32), bl, nb, D ** -0.5)
    for off in range(0, L, C):
        n = min(C, L - off)
        qc = torch.zeros((1, H, C, D), dtype=dtype, device="cuda")
        qc[:, :, :n] = q[:, :, off:off + n]
        out = paged_attention_cuda(qc, k, v, table,
                                   torch.tensor([off + n], **i32),
                                   torch.tensor([off], **i32), bl, nb,
                                   D ** -0.5)
        assert torch.equal(out[:, :, :n], whole[:, :, off:off + n]), \
            f"chunk at offset {off} diverged from whole-prompt prefill"


# LayerNorm shapes: every width bucket of csrc/layernorm.cu that the
# repo's models reach (GPT widths 768..4096), ragged widths (1000 is whole
# 16-byte packs in both dtypes, 8191 is not), one to 70001 rows, and bf16
# rows at an odd storage offset (element 1 of a buffer), which take the
# scalar-access instantiations.
_LN_WIDTHS = (64, 128, 768, 1000, 1024, 2048, 4096, 8191, 8192)
_LN_ROWS = (1, 7, 512, 4096, 70001)
_LN_CASES = (
    [(dt, 7, n, 0) for n in _LN_WIDTHS
     for dt in (torch.float32, torch.bfloat16)]
    + [(torch.bfloat16, r, 2048, 0) for r in _LN_ROWS if r != 7]
    + [(torch.float32, r, 1000, 0) for r in _LN_ROWS if r != 7]
    + [(torch.float32, 70001, 64, 0), (torch.bfloat16, 70001, 768, 0),
       (torch.float32, 512, 2048, 0), (torch.float32, 3, 8192, 0),
       (torch.float32, 5, 1000, 0),
       (torch.bfloat16, 512, 2048, 1), (torch.bfloat16, 7, 1000, 1),
       (torch.bfloat16, 3, 8192, 1), (torch.bfloat16, 4096, 8191, 1)])


def _ln_to_cuda(a, dtype, offset=0):
    """`a` on the card in `dtype`; with `offset`, as a view starting
    `offset` elements into its buffer (contiguous, not 16-byte aligned)."""
    t = torch.from_numpy(a).to("cuda", dtype)
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, device="cuda", dtype=dtype)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,N,offset", _LN_CASES)
def test_cuda_layernorm_matches_plain(dtype, R, N, offset):
    require_cuda()
    from paddle_tpu_torch.ops.layernorm import (aligned16, fwd_config,
                                                layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    x, w, b = (_ln_to_cuda(a, dtype, offset)
               for a in layernorm_inputs(4, (R, N), N))
    if offset:
        assert fwd_config(N, dtype, aligned16(x, w, b)).width == 1
    y, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    ry, rmu, rrstd = layer_norm_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(y, ry, atol=1e-5, rtol=1e-5)
    else:
        big = torch.maximum(y.float().abs(), ry.float().abs()).cpu().numpy()
        err = (y.float() - ry.float()).abs().cpu().numpy()
        assert (err <= ulp_bf16(big) + 1e-5).all()
    torch.testing.assert_close(mu, rmu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    if offset:
        # both access widths visit the values in one order: the same bits
        aligned = layer_norm_fwd_cuda(*(t.contiguous().clone()
                                        for t in (x, w, b)), 1e-5)
        for a, o in zip(aligned, (y, mu, rstd)):
            assert torch.equal(a, o)


# A row's forward is its own: the first 64 rows of a 512-row call equal a
# 64-row call, and each equals a one-row call, bit for bit. The engine's
# 512-row steps and generate()'s 64-row prefill rely on it.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,N", [(torch.bfloat16, 2048),
                                     (torch.float32, 1000)])
def test_cuda_layernorm_rows_are_independent(dtype, N):
    require_cuda()
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_cuda
    x, w, b = (torch.from_numpy(a).to("cuda", dtype)
               for a in layernorm_inputs(9, (512, N), N))
    full = layer_norm_fwd_cuda(x, w, b, 1e-5)
    head = layer_norm_fwd_cuda(x[:64], w, b, 1e-5)
    for f, h in zip(full, head):
        assert torch.equal(f[:64], h)
    for i in range(64):
        one = layer_norm_fwd_cuda(x[i:i + 1], w, b, 1e-5)
        for h, o in zip(head, one):
            assert torch.equal(h[i:i + 1], o), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,N", [(torch.bfloat16, 4096, 2048),
                                       (torch.float32, 7, 8191),
                                       (torch.bfloat16, 70001, 768)])
def test_cuda_layernorm_forward_is_bitwise_deterministic(dtype, R, N):
    require_cuda()
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_cuda
    x, w, b = (torch.from_numpy(a).to("cuda", dtype)
               for a in layernorm_inputs(10, (R, N), N))
    runs = [layer_norm_fwd_cuda(x, w, b, 1e-5) for _ in range(2)]
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs():
    require_cuda()
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_cuda
    from paddle_tpu_torch.ops.paged_attention import paged_attention_cuda
    x = torch.zeros((4, 16), device="cuda")
    w = torch.ones(16, device="cuda")
    with pytest.raises(TypeError, match="one dtype"):
        layer_norm_fwd_cuda(x, w.half(), w, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm_fwd_cuda(torch.zeros((16, 4), device="cuda").t(), w, w,
                            1e-5)
    with pytest.raises(ValueError, match="N <= 8192"):
        layer_norm_fwd_cuda(torch.zeros((1, 8193), device="cuda"),
                            torch.ones(8193, device="cuda"),
                            torch.ones(8193, device="cuda"), 1e-5)
    q = torch.zeros((1, 2, 3, 32), device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_cuda(q, q, q, torch.zeros((1, 1), **i32),
                             torch.ones(1, **i32), torch.zeros(1, **i32),
                             1, 3, 1.0)


def _t(rng, shape, dtype):
    import numpy as np
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to("cuda", dtype)


def _assert_bf16_train(got, plain_bf16, plain_fp32):
    from chip_smoke import bf16_vs_fp32_plain
    err_k, err_p, limit = bf16_vs_fp32_plain(torch, got, plain_bf16,
                                             plain_fp32)
    assert err_k <= limit, (err_k, err_p, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,Sq,Sk,D,causal", [
    (torch.float32, 2, 3, 128, 128, 128, True),
    (torch.float32, 1, 2, 100, 300, 64, True),      # Sq < Sk
    (torch.float32, 1, 2, 300, 100, 64, True),      # Sq > Sk: empty rows
    (torch.float32, 2, 2, 77, 130, 32, False),
    (torch.float32, 1, 1, 5, 5, 16, True),
    (torch.bfloat16, 2, 4, 256, 256, 128, True),
    (torch.bfloat16, 1, 4, 190, 70, 64, False),     # Sq > Sk, not causal
    # the tensor-core path's edges: D = 16..128 (96 runs padded to 128),
    # one-row and ragged tiles, Sq < Sk and Sq > Sk, B*H past 132 SMs
    (torch.bfloat16, 1, 2, 1, 1, 16, True),
    (torch.bfloat16, 1, 3, 63, 63, 32, True),
    (torch.bfloat16, 2, 2, 65, 65, 64, False),
    (torch.bfloat16, 1, 2, 333, 333, 128, True),
    (torch.bfloat16, 1, 2, 77, 77, 96, True),
    (torch.bfloat16, 1, 2, 100, 300, 64, True),     # Sq < Sk
    (torch.bfloat16, 1, 2, 100, 300, 128, False),
    (torch.bfloat16, 1, 2, 300, 100, 32, True),     # Sq > Sk: empty rows
    (torch.bfloat16, 4, 40, 128, 128, 128, True),   # B*H = 160
    (torch.bfloat16, 1, 32, 4096, 4096, 128, True),  # llama2-7b's train step
])
def test_cuda_flash_attention_matches_plain(dtype, B, H, Sq, Sk, D, causal):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.attention import (flash_attention,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    rng = np.random.RandomState(31)
    q, g = _t(rng, (B, H, Sq, D), dtype), _t(rng, (B, H, Sq, D), dtype)
    k, v = _t(rng, (B, H, Sk, D), dtype), _t(rng, (B, H, Sk, D), dtype)
    scale = D ** -0.5
    before = launch_counts()
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    delta = flash_attention_delta(g, out)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale)
    ref = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
        for got, want in zip((dq, dk, dv), ref):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        f32 = [t.float() for t in (q, k, v, g)]
        _assert_bf16_train(out, ref_out,
                           flash_fwd_plain(*f32[:3], causal, scale)[0])
        ref32 = flash_bwd_plain(*f32, lse, delta, causal, scale)
        for got, want, want32 in zip((dq, dk, dv), ref, ref32):
            _assert_bf16_train(got, want, want32)
    # the autograd entry point launches the three kernels once each
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o2 = flash_attention(qr, kr, vr, causal=causal)
    o2.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(o2.detach(), out)
    assert torch.equal(qr.grad, dq) and torch.equal(kr.grad, dk) \
        and torch.equal(vr.grad, dv)
    after = launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 2, name


@pytest.mark.cuda
def test_cuda_flash_backward_is_bitwise_deterministic():
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_fwd_cuda)
    rng = np.random.RandomState(32)
    q, k, v, g = (_t(rng, (2, 4, 320, 128), torch.bfloat16)
                  for _ in range(4))
    # the forward too: fixed-order sums, no atomics
    fwd = [flash_fwd_cuda(q, k, v, True, 128 ** -0.5) for _ in range(2)]
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    out, lse = fwd[0]
    delta = flash_attention_delta(g, out)
    runs = [(flash_bwd_dq_cuda(q, k, v, g, lse, delta, True, 128 ** -0.5),
             *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True, 128 ** -0.5))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# fp16 (AMP in float16): the same tensor-core kernels over __half, each
# against its plain version under chip_smoke.py's FP16_TRAIN_* rule (the
# bf16 rule at fp16's ulp), two runs bit-equal, launched under their own
# counters and never through the bf16 or scalar instantiations
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (4, 16, 1024, 1024, 128, True),     # gpt3-1.3b's train step
    (1, 2, 1, 1, 16, True),
    (1, 3, 63, 63, 32, True),
    (2, 2, 65, 65, 64, False),
    (1, 2, 333, 333, 128, True),
    (1, 2, 77, 77, 96, True),
    (1, 2, 100, 300, 64, True),         # Sq < Sk
    (1, 2, 300, 100, 32, True),         # Sq > Sk: empty rows
    (4, 40, 128, 128, 128, True),       # B*H = 160
])
def test_cuda_flash_fp16_matches_plain(B, H, Sq, Sk, D, causal):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.attention import (flash_attention,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    rng = np.random.RandomState(33)
    h = torch.float16
    q, g = _t(rng, (B, H, Sq, D), h), _t(rng, (B, H, Sq, D), h)
    k, v = _t(rng, (B, H, Sk, D), h), _t(rng, (B, H, Sk, D), h)
    scale = D ** -0.5
    before = launch_counts()
    runs = []
    for _ in range(2):
        out, lse = flash_fwd_cuda(q, k, v, causal, scale)
        delta = flash_attention_delta(g, out)
        runs.append((out, lse,
                     flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale),
                     *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal,
                                         scale)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, lse, dq, dk, dv = runs[0]
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == h
    delta = flash_attention_delta(g, out)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    f32 = [t.float() for t in (q, k, v, g)]
    _assert_bf16_train(out, ref_out,
                       flash_fwd_plain(*f32[:3], causal, scale)[0])
    ref = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale)
    ref32 = flash_bwd_plain(*f32, lse, delta, causal, scale)
    for got, want, want32 in zip((dq, dk, dv), ref, ref32):
        _assert_bf16_train(got, want, want32)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o2 = flash_attention(qr, kr, vr, causal=causal)
    o2.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(o2.detach(), out) and torch.equal(qr.grad, dq)
    after = launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name + "_fp16"] == before[name + "_fp16"] + 3, name
        assert after[name] == before[name], name


# (The name predates the fp16 variants: an fp16 mask and fp16 dropout now
# run the variants' fp16 instantiations on the tensor cores, under their
# own counters; a mask with dropout takes the plain reference, as in
# bf16; a misaligned input still raises.)
@pytest.mark.cuda
def test_cuda_flash_fp16_routes_and_refuses_variants():
    require_cuda()
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.attention import (flash_attention,
                                                flash_attention_delta,
                                                flash_bwd_dq_cuda,
                                                flash_fwd_cuda)
    q = torch.randn((1, 2, 64, 64), device="cuda").half()
    before = launch_counts()
    out, lse = flash_fwd_cuda(q, q, q, True, 1.0)
    flash_bwd_dq_cuda(q, q, q, q, lse, flash_attention_delta(q, out), True,
                      1.0)
    torch.cuda.synchronize()
    after = launch_counts()
    # the fp16 instantiations' counters, never the bf16/fp32 ones (their
    # tensor-core machine code: test_cuda_flash_bf16_kernels_run_on_
    # tensor_cores)
    assert after["flash_fwd_fp16"] == before["flash_fwd_fp16"] + 1
    assert after["flash_bwd_dq_fp16"] == before["flash_bwd_dq_fp16"] + 1
    assert after["flash_fwd"] == before["flash_fwd"]
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"]
    # (fp16 has no scalar kernel: code 2 reaches only the tensor-core
    # launchers, whose __half instantiations' machine code holds HGMMA,
    # test_cuda_flash_bf16_kernels_run_on_tensor_cores)
    mask = torch.zeros((1, 1, 64, 64), device="cuda")
    for m, p, suffix in ((mask, 0.0, "_mask_fp16"),
                         (None, 0.1, "_dropout_fp16")):
        before = launch_counts()
        qr = q.clone().requires_grad_()
        out = flash_attention(qr, q, q, mask=m, dropout_p=p)
        out.backward(q)
        torch.cuda.synchronize()
        assert out.dtype == torch.float16 and torch.isfinite(out).all()
        after = launch_counts()
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert after[name + suffix] == before[name + suffix] + 1, name
            assert after[name + "_fp16"] == before[name + "_fp16"], name
    # a mask with dropout: the plain reference, no kernel
    before = launch_counts()
    flash_attention(q, q, q, mask=mask, dropout_p=0.1)
    assert launch_counts() == before
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd_cuda(flat[1:].view(q.shape), q, q, True, 1.0)


# fp32 dw and db at 70001 rows and 1000 columns are held by the test
# after this one: any two fp32 orders of those sums part by more than the
# 1e-4 that covers sums of up to 4096 products (the plain version itself
# is 1.7e-4 from the fp64 sum there, on the H100); fp32 at 70001 rows
# stays here at N = 64.
_LN_BWD_CASES = (
    [(dt, 7, n, 0) for n in _LN_WIDTHS
     for dt in (torch.float32, torch.bfloat16)]
    + [(torch.bfloat16, r, 2048, 0) for r in _LN_ROWS if r != 7]
    + [(torch.float32, r, 1000, 0) for r in _LN_ROWS if r not in (7, 70001)]
    + [(torch.float32, 4096, 2048, 0), (torch.float32, 3, 8192, 0),
       (torch.float32, 70001, 64, 0), (torch.bfloat16, 70001, 64, 0),
       (torch.bfloat16, 4096, 2048, 1), (torch.bfloat16, 7, 1000, 1),
       (torch.bfloat16, 3, 8192, 1), (torch.bfloat16, 512, 8191, 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,N,offset", _LN_BWD_CASES)
def test_cuda_layernorm_backward_matches_plain(dtype, R, N, offset):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops.layernorm import (aligned16, bwd_config,
                                                fused_layer_norm,
                                                layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    x, w, b = (_ln_to_cuda(a, dtype, offset)
               for a in layernorm_inputs(5, (R, N), N))
    dy = _ln_to_cuda(np.random.RandomState(6).standard_normal((R, N))
                     .astype(np.float32), dtype, offset)
    if offset:
        assert bwd_config(N, dtype, aligned16(x, w, dy)).width == 1
    _, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    got = layer_norm_bwd_cuda(x, w, mu, rstd, dy)
    ref = layer_norm_bwd_plain(x, w, mu, rstd, dy)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
        for a, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)
    else:
        ref32 = layer_norm_bwd_plain(x.float(), w.float(), mu, rstd,
                                     dy.float())
        for a, r, r32 in zip(got, ref, ref32):
            assert a.dtype == torch.bfloat16
            _assert_bf16_train(a, r, r32)
    # run to run: dw and db bit for bit (no atomics)
    again = layer_norm_bwd_cuda(x, w, mu, rstd, dy)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    # the differentiable entry point runs the forward and backward kernels
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    fused_layer_norm(xr, wr, br).backward(dy)
    torch.cuda.synchronize()
    for t, want in zip((xr, wr, br), got):
        assert torch.equal(t.grad, want)
    if offset:
        # both access widths visit the values in one order: the same bits
        aligned = layer_norm_bwd_cuda(x.clone(), w.clone(), mu, rstd,
                                      dy.clone())
        for a, o in zip(aligned, got):
            assert torch.equal(a, o)


# fp16 (pure-fp16 training, fp16 serving): the forward and backward under
# chip_smoke.py's FP16_TRAIN_* rule (the fp32 plain version on the same
# fp16 inputs the yardstick), mean and rstd within 1e-5, two runs
# bit-equal, scalar width (a view at an odd offset) bit-equal to 16-byte
# width, counted as layernorm_fwd_fp16 / layernorm_bwd_fp16 and never as
# the fp32 or bf16 instantiations
@pytest.mark.cuda
@pytest.mark.parametrize("R,N,offset", [
    (512, 2048, 0), (4096, 2048, 0), (5, 1000, 0), (3, 8192, 0),
    (7, 768, 0), (512, 2048, 1), (7, 1000, 1)])
def test_cuda_layernorm_fp16_matches_plain(R, N, offset):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.layernorm import (aligned16, bwd_config,
                                                fwd_config,
                                                layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    h = torch.float16
    x, w, b = (_ln_to_cuda(a, h, offset)
               for a in layernorm_inputs(7, (R, N), N))
    dy = _ln_to_cuda(np.random.RandomState(8).standard_normal((R, N))
                     .astype(np.float32), h, offset)
    if offset:
        assert fwd_config(N, h, aligned16(x, w, b)).width == 1
        assert bwd_config(N, h, aligned16(x, w, dy)).width == 1
    before = launch_counts()
    fwd = [layer_norm_fwd_cuda(x, w, b, 1e-5) for _ in range(2)]
    y, mu, rstd = fwd[0]
    bwd = [layer_norm_bwd_cuda(x, w, mu, rstd, dy) for _ in range(2)]
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ("layernorm_fwd", "layernorm_bwd"):
        assert after[name + "_fp16"] == before[name + "_fp16"] + 2, name
        assert after[name] == before[name], name
    for a, b_ in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
        assert torch.equal(a, b_)
    ry, rmu, rrstd = layer_norm_fwd_plain(x, w, b, 1e-5)
    torch.testing.assert_close(mu, rmu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    assert y.dtype == h
    _assert_bf16_train(y, ry, layer_norm_fwd_plain(x.float(), w.float(),
                                                   b.float(), 1e-5)[0])
    ref = layer_norm_bwd_plain(x, w, mu, rstd, dy)
    ref32 = layer_norm_bwd_plain(x.float(), w.float(), mu, rstd, dy.float())
    for a, r, r32 in zip(bwd[0], ref, ref32):
        assert a.dtype == h
        _assert_bf16_train(a, r, r32)
    if offset:
        # both access widths visit the values in one order: the same bits
        clean = [t.contiguous().clone() for t in (x, w, b, dy)]
        for a, o in zip(layer_norm_fwd_cuda(*clean[:3], 1e-5), fwd[0]):
            assert torch.equal(a, o)
        for a, o in zip(layer_norm_bwd_cuda(clean[0], clean[1], mu, rstd,
                                            clean[3]), bwd[0]):
            assert torch.equal(a, o)


# dw and db over many rows in fp32: each side's largest error from the
# fp64 sum of the same terms; the kernel's may be at most
# BF16_TRAIN_FACTOR times the plain version's, plus 1e-5 (the rule the
# bf16 kernels follow, with fp64 as the yardstick). A run of rows a CTA
# longer than BWD_MAX_ROWS, or a partial summed out of order, moves the
# kernel's error away from the plain version's.
@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(70001, 1000), (20000, 2048)])
def test_cuda_layernorm_backward_long_sums_within_plain_error(R, N):
    require_cuda()
    import numpy as np
    from chip_smoke import BF16_TRAIN_FACTOR
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    x, w, b = (torch.from_numpy(a).to("cuda")
               for a in layernorm_inputs(11, (R, N), N))
    dy = _t(np.random.RandomState(12), (R, N), torch.float32)
    _, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    got = layer_norm_bwd_cuda(x, w, mu, rstd, dy)[1:]
    plain = layer_norm_bwd_plain(x, w, mu, rstd, dy)[1:]
    xhat = (x.double() - mu.double()) * rstd.double()
    exact = ((dy.double() * xhat).sum(0), dy.double().sum(0))
    for name, k, p, e in zip(("dw", "db"), got, plain, exact):
        err_k = float((k.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= BF16_TRAIN_FACTOR * err_p + 1e-5, \
            (name, err_k, err_p)


# (The name predates the variants.) A mask or dropout on CUDA now launches
# its variant kernel; a mask with dropout goes to the plain reference
# through flash_attention and is refused by the kernels' wrappers; bad
# inputs still raise.
@pytest.mark.cuda
def test_cuda_flash_refuses_mask_dropout_and_bad_inputs():
    require_cuda()
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.attention import flash_attention, \
        flash_fwd_cuda
    q = torch.zeros((1, 2, 8, 64), device="cuda")
    before = launch_counts()
    out = flash_attention(q, q, q, mask=torch.zeros((1, 1, 8, 8),
                                                    device="cuda"))
    out = flash_attention(q, q, q, dropout_p=0.1)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    after = launch_counts()
    for name in ("flash_fwd_mask", "flash_fwd_dropout"):
        assert after[name] == before[name] + 1, name
    assert after["flash_fwd"] == before["flash_fwd"]
    with pytest.raises(ValueError, match="not both"):
        flash_fwd_cuda(q, q, q, True, 1.0, torch.zeros((1, 1, 8, 8),
                                                       device="cuda"), 0.1)
    with pytest.raises(ValueError, match="batch dim"):
        flash_fwd_cuda(q, q, q, True, 1.0, torch.zeros((3, 1, 8, 8),
                                                       device="cuda"))
    with pytest.raises(ValueError, match="dropout_p"):
        flash_fwd_cuda(q, q, q, True, 1.0, dropout_p=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd_cuda(torch.zeros((1, 2, 8, 40), device="cuda"),
                       torch.zeros((1, 2, 8, 40), device="cuda"),
                       torch.zeros((1, 2, 8, 40), device="cuda"), True, 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        flash_fwd_cuda(q, q, q.bfloat16(), True, 1.0)


# ---- the mask and dropout variants of the forward, dq and dk/dv kernels:
# each against its plain version (fp32 1e-5 / 1e-4; bf16 the training
# kernels' rule), the dropout keep-mask bit for bit, the bf16 route, and
# two runs bit-equal
VARIANT_CASES = [  # dtype, B, H, Sq, Sk, D, causal, variant
    (torch.float32, 2, 3, 100, 130, 64, False, "mask_b1"),
    (torch.float32, 1, 2, 128, 128, 128, True, "mask_bh_inf"),
    (torch.float32, 1, 2, 77, 64, 32, True, "mask_3d"),
    (torch.float32, 2, 2, 100, 130, 64, True, "dropout"),
    (torch.float32, 1, 2, 300, 100, 64, True, "dropout"),   # empty rows
    (torch.bfloat16, 2, 3, 100, 130, 64, False, "mask_b1"),
    (torch.bfloat16, 2, 4, 256, 256, 128, True, "mask_bh_inf"),
    (torch.bfloat16, 1, 2, 77, 77, 96, True, "mask_3d_bf16"),
    (torch.bfloat16, 1, 2, 129, 257, 128, False, "mask_odd_sk"),
    (torch.float32, 2, 3, 100, 130, 64, True, "mask_b11_bf16"),
    (torch.bfloat16, 2, 4, 256, 256, 128, False, "mask_b11_bf16"),
    (torch.bfloat16, 2, 4, 256, 256, 128, True, "dropout"),
    (torch.bfloat16, 1, 2, 100, 300, 64, False, "dropout"),
    (torch.bfloat16, 1, 2, 300, 100, 32, True, "dropout"),  # empty rows
    # the fp16 instantiations (pure-fp16 training), under the fp16 rule
    (torch.float16, 2, 3, 100, 130, 64, False, "mask_b1"),
    (torch.float16, 2, 4, 256, 256, 128, True, "mask_bh_inf"),
    (torch.float16, 1, 2, 77, 77, 96, True, "mask_3d"),
    (torch.float16, 2, 4, 256, 256, 128, True, "dropout"),
    (torch.float16, 1, 2, 300, 100, 32, True, "dropout"),   # empty rows
]


def _variant_inputs(rng, dtype, B, H, Sq, Sk, variant):
    """(mask, dropout_p, seed) of a variant case."""
    import numpy as np
    if variant == "dropout":
        return None, 0.1, (5 << 32) + 12345
    shape = {"mask_b1": (B, 1, Sq, Sk), "mask_bh_inf": (B, H, Sq, Sk),
             "mask_3d": (B, Sq, Sk), "mask_3d_bf16": (B, Sq, Sk),
             "mask_odd_sk": (1, 1, Sq, Sk),
             "mask_b11_bf16": (B, 1, 1, Sk)}[variant]
    m = rng.standard_normal(shape).astype(np.float32)
    if variant == "mask_bh_inf":
        m = np.where(rng.rand(*shape) < 0.3, -np.inf, 0.0).astype(np.float32)
        m[..., 7, :] = -np.inf                   # a row masked whole
    mask = torch.from_numpy(m).to("cuda")
    return (mask.bfloat16() if variant.endswith("_bf16") else mask), 0.0, 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,Sq,Sk,D,causal,variant", VARIANT_CASES)
def test_cuda_flash_variants_match_plain(dtype, B, H, Sq, Sk, D, causal,
                                         variant):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                flash_attention,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    rng = np.random.RandomState(41)
    q, g = _t(rng, (B, H, Sq, D), dtype), _t(rng, (B, H, Sq, D), dtype)
    k, v = _t(rng, (B, H, Sk, D), dtype), _t(rng, (B, H, Sk, D), dtype)
    mask, p, seed = _variant_inputs(rng, dtype, B, H, Sq, Sk, variant)
    keep = dropout_keep_mask(seed, B, H, Sq, Sk, p, "cuda") if p else None
    scale = D ** -0.5
    before = launch_counts()
    out, lse = flash_fwd_cuda(q, k, v, causal, scale, mask, p, seed)
    delta = flash_attention_delta(g, out)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, mask, p,
                           seed)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale, mask,
                                p, seed)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale, mask, keep, p)
    ref = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale, mask, keep,
                          p)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
        for got, want in zip((dq, dk, dv), ref):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        f32 = [t.float() for t in (q, k, v, g)]
        _assert_bf16_train(out, ref_out, flash_fwd_plain(
            *f32[:3], causal, scale, mask, keep, p)[0])
        ref32 = flash_bwd_plain(*f32, lse, delta, causal, scale, mask, keep,
                                p)
        for got, want, want32 in zip((dq, dk, dv), ref, ref32):
            _assert_bf16_train(got, want, want32)
    if variant == "mask_bh_inf":      # the row masked whole: 0 everywhere
        assert not out[..., 7, :].any() and not dq[..., 7, :].any()
    # the autograd entry point launches the three variant kernels once each
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o2 = flash_attention(qr, kr, vr, causal=causal, scale=scale, mask=mask,
                         dropout_p=p, dropout_seed=seed)
    o2.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(o2.detach(), out)
    assert torch.equal(qr.grad, dq) and torch.equal(kr.grad, dk) \
        and torch.equal(vr.grad, dv)
    suffix = ("_dropout" if p else "_mask") + (
        "_fp16" if dtype == torch.float16 else "")
    after = launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name + suffix] == before[name + suffix] + 2, name
        assert after[name] == before[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,seed,p", [
    (2, 3, 100, 130, 0, 0.1), (1, 4, 257, 63, (1 << 40) + 7, 0.5),
    (4, 16, 1024, 1024, 123456789, 0.1)])
def test_cuda_dropout_keep_mask_is_the_plain_twin_bit_for_bit(B, H, Sq, Sk,
                                                              seed, p):
    require_cuda()
    import math
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                dropout_keep_mask_cuda)
    got = dropout_keep_mask_cuda(seed, B, H, Sq, Sk, p)
    want = dropout_keep_mask(seed, B, H, Sq, Sk, p, "cuda")
    assert torch.equal(got, want)
    n = got.numel()
    assert abs(float(got.float().mean()) - (1 - p)) < 5 * math.sqrt(
        p * (1 - p) / n)
    assert not torch.equal(dropout_keep_mask_cuda(seed + 1, B, H, Sq, Sk, p),
                           got)


# bf16 variants: two runs bit-equal, another seed another result, and the
# kernels launched are the tensor-core ones (torch.profiler's names)
@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mask_b1", "dropout"])
def test_cuda_flash_bf16_variants_are_deterministic_on_tensor_cores(variant):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_fwd_cuda)
    rng = np.random.RandomState(42)
    bf = torch.bfloat16
    q, k, v, g = (_t(rng, (2, 4, 320, 128), bf) for _ in range(4))
    mask, p, seed = _variant_inputs(rng, bf, 2, 4, 320, 320, variant)

    def run(seed_):
        out, lse = flash_fwd_cuda(q, k, v, True, 128 ** -0.5, mask, p, seed_)
        delta = flash_attention_delta(g, out)
        return (out, lse,
                flash_bwd_dq_cuda(q, k, v, g, lse, delta, True, 128 ** -0.5,
                                  mask, p, seed_),
                *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True,
                                    128 ** -0.5, mask, p, seed_))

    first, second = run(seed), run(seed)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    if p:
        assert not torch.equal(run(seed + 1)[0], first[0])
    names = _kernel_names(lambda: run(seed))
    for kern in ("flash_fwd_kernel_tc", "flash_bwd_dq_kernel_tc",
                 "flash_bwd_dkv_kernel_tc"):
        assert any(kern in n for n in names), (kern, names)
    assert not any("flash_fwd_kernel<" in n or "flash_bwd_dq_kernel<" in n
                   or "flash_bwd_dkv_kernel<" in n for n in names), names


# A bf16 input the tensor-core kernels cannot take raises: it is never
# routed to the scalar kernel or the plain version.
def _kernel_names(fn):
    """The names of the CUDA kernels `fn()` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.cuda
def test_cuda_flash_bf16_never_reaches_another_route():
    require_cuda()
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_fwd_cuda)
    bf = torch.bfloat16
    q = torch.randn((1, 2, 64, 64), device="cuda").to(bf)
    before = launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(q.transpose(2, 3), q, q, True, 1.0)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        flash_fwd_cuda(q.double(), q.double(), q.double(), True, 1.0)
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=bf)
    off = flat[1:].view(q.shape)          # contiguous, 2 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd_cuda(off, q, q, True, 1.0)
    out, lse = flash_fwd_cuda(q, q, q, True, 1.0)
    delta = flash_attention_delta(q, out)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dkv_cuda(q, q, q, off, lse, delta, True, 1.0)
    for bad in ((off, q, q, q), (q, off, q, q), (q, q, q, off)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_bwd_dq_cuda(*bad, lse, delta, True, 1.0)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"]
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"]
    # bf16 dq runs the tensor-core kernel and never the scalar one
    names = _kernel_names(lambda: flash_bwd_dq_cuda(q, q, q, q, lse, delta,
                                                    True, 1.0))
    assert any("flash_bwd_dq_kernel_tc" in n for n in names), names
    assert not any("flash_bwd_dq_kernel<" in n for n in names), names


# One strategy step under AMP (parallelize with amp, a 2-layer model of
# gpt3-1.3b's widths in fp32 master weights): the attention runs the flash
# kernels of the AMP dtype (bf16, or the fp16 instantiations) on inputs of
# that dtype, the LayerNorm kernels run on the fp32 residual stream and
# the update is fused Adam with the device flag, as the launch counts and
# the dtypes seen by hooks show; with fp16 a first step forced to
# overflow skips the update on the device: the weights stay bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_amp_plan_step_routes_to_kernels(dtype):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    m = GPTForCausalLM.from_preset("gpt3-1.3b", num_hidden_layers=2)
    m.train()
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": dtype, "init_loss_scaling": 2.0 ** 40,
                     "decr_every_n_nan_or_inf": 1}
    step = parallelize(m, AdamW(learning_rate=1e-4,
                                parameters=m.parameters()), strategy=s)
    ids = np.random.RandomState(3).randint(0, 50304, (2, 128)).astype(
        np.int32)
    w0 = m.lm_head.weight.detach().clone()
    seen = set()
    hooks = [m.gpt.layers[0].self_attn.qkv_proj.register_forward_hook(
        lambda mod, a, o: seen.add(("attention", o.dtype))),
        m.gpt.layers[0].norm1.register_forward_pre_hook(
        lambda mod, a: seen.add(("layernorm", a[0].dtype)))]
    reset_launch_counts()
    step(ids, ids)
    torch.cuda.synchronize()
    n = launch_counts()
    for h in hooks:
        h.remove()
    half = dtype == "float16"
    assert seen == {("attention", torch.float16 if half else torch.bfloat16),
                    ("layernorm", torch.float32)}, seen
    sfx, other = ("_fp16", "") if half else ("", "_fp16")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert n[k + sfx] == 2 and n[k + other] == 0, (k, n)
    assert n["layernorm_fwd"] == 5 and n["layernorm_bwd"] == 5
    assert n["fused_adam"] == 29
    if half:
        # 2^40 overflows fp16: the update was skipped on the device
        assert torch.equal(m.lm_head.weight.detach(), w0)
        assert step.loss_scale == float(np.float32(2.0 ** 40)
                                        * np.float32(0.8))
    else:
        assert not torch.equal(m.lm_head.weight.detach(), w0)


# Pure fp16 (O2: amp.decorate casts every parameter to fp16,
# AdamW(multi_precision=True) keeps fp32 masters) through the same step:
# every kernel runs its fp16 instantiation, on fp16 inputs (the
# LayerNorms see the fp16 residual stream), none the fp32 or bf16 one;
# each fp16 parameter is its updated master rounded once.
@pytest.mark.cuda
def test_cuda_o2_plan_step_routes_to_fp16_kernels():
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    m = GPTForCausalLM.from_preset("gpt3-1.3b", num_hidden_layers=2)
    decorate(m, level="O2", dtype="float16")
    m.train()
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "float16"}
    opt = AdamW(learning_rate=1e-4, parameters=m.parameters(),
                multi_precision=True)
    step = parallelize(m, opt, strategy=s)
    ids = np.random.RandomState(3).randint(0, 50304, (2, 128)).astype(
        np.int32)
    w0 = m.lm_head.weight.detach().clone()
    seen = set()
    hooks = [m.gpt.layers[0].self_attn.qkv_proj.register_forward_hook(
        lambda mod, a, o: seen.add(("attention", o.dtype))),
        m.gpt.layers[0].norm1.register_forward_pre_hook(
        lambda mod, a: seen.add(("layernorm", a[0].dtype)))]
    reset_launch_counts()
    step(ids, ids)
    torch.cuda.synchronize()
    n = launch_counts()
    for h in hooks:
        h.remove()
    assert seen == {("attention", torch.float16),
                    ("layernorm", torch.float16)}, seen
    want = {"flash_fwd_fp16": 2, "flash_bwd_dq_fp16": 2,
            "flash_bwd_dkv_fp16": 2, "layernorm_fwd_fp16": 5,
            "layernorm_bwd_fp16": 5, "fused_adam_fp16": 29}
    assert {k: v for k, v in n.items() if v} == want, n
    assert step.loss_scale == 32768.0
    assert not torch.equal(m.lm_head.weight.detach(), w0)
    for p in m.parameters():
        master = opt.state[p]["master_weight"]
        assert p.dtype == torch.float16 and master.dtype == torch.float32
        assert torch.equal(p.detach(), master.half())


# The route rule of pdtt_paged_attention, seen from the kernels a call
# launches: bf16 at block_len 8 (the engine's) or any multiple of 8 runs
# the tensor-core kernel and never the scalar one; fp32 and bf16 at other
# block lengths run the scalar kernel, as paged_route says. A misaligned
# bf16 input raises.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bl", [
    (torch.bfloat16, 8), (torch.bfloat16, 16), (torch.bfloat16, 40),
    (torch.bfloat16, 12), (torch.float32, 8),
    # fp16 (fp16 serving) takes the same routes as bf16
    (torch.float16, 8), (torch.float16, 40), (torch.float16, 12)])
def test_cuda_paged_bf16_never_reaches_another_route(dtype, bl):
    require_cuda()
    from paddle_tpu_torch.ops import _kernels, launch_counts
    from paddle_tpu_torch.ops.paged_attention import (TENSOR_CORES,
                                                      paged_attention_cuda,
                                                      paged_route)
    c = paged_inputs(22, H=4, Hkv=2, D=128, bl=bl, Tq=16)
    t = lambda a: torch.from_numpy(a).to("cuda", dtype)    # noqa: E731
    i = lambda a: torch.from_numpy(a).to("cuda")            # noqa: E731
    args = [t(c["q"]), t(c["k"]), t(c["v"]), i(c["table"]), i(c["lens"]),
            i(c["q_pos"]), bl, c["ppr"], 128 ** -0.5]
    names = _kernel_names(lambda: paged_attention_cuda(*args))
    # the launch counted under the route the library took
    routes = _kernels.route_counts()
    paged_attention_cuda(*args)
    name = _kernels.fp16_name("paged_attention", dtype)
    routes[f"{name}:{paged_route(dtype, bl, 128)}"] += 1
    assert _kernels.route_counts() == routes
    tc = any("paged_attention_kernel_tc" in n for n in names)
    scalar = any("paged_attention_kernel<" in n for n in names)
    assert (tc, scalar) == ((True, False)
                            if paged_route(dtype, bl, 128) == TENSOR_CORES
                            else (False, True)), names
    if paged_route(dtype, bl, 128) != TENSOR_CORES:
        return
    before = launch_counts()
    for j in range(3):
        flat = torch.zeros(args[j].numel() + 1, device="cuda", dtype=dtype)
        bad = list(args)
        bad[j] = flat[1:].view(args[j].shape)   # 2 bytes off 16
        with pytest.raises(ValueError, match="16-byte"):
            paged_attention_cuda(*bad)
    assert launch_counts() == before


# bf16 paged attention sums every row in one fixed order: two runs are
# bit-equal, at the served shape and with GQA.
@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv", [(16, 16), (16, 4)])
def test_cuda_paged_attention_is_bitwise_deterministic(H, Hkv):
    require_cuda()
    from paddle_tpu_torch.ops.paged_attention import paged_attention_cuda
    c = paged_inputs(23, H=H, Hkv=Hkv, D=128, bl=8, Tq=64, ppr=40,
                     lens=(300, 17, 129), decode_rows=(1,))
    t = lambda a: torch.from_numpy(a).to("cuda", torch.bfloat16)  # noqa
    i = lambda a: torch.from_numpy(a).to("cuda")                  # noqa
    args = (t(c["q"]), t(c["k"]), t(c["v"]), i(c["table"]), i(c["lens"]),
            i(c["q_pos"]), 8, c["ppr"], 128 ** -0.5)
    runs = [paged_attention_cuda(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


# The machine code of the bf16 flash forward, dq and dk/dv kernels (and
# of their fp16 instantiations) holds warpgroup products (wgmma's HGMMA),
# that of the bf16 paged attention warp products (mma.sync's HMMA), as
# chip_smoke.TENSOR_CORE_KERNELS states (cuobjdump -sass).
@pytest.mark.cuda
def test_cuda_flash_bf16_kernels_run_on_tensor_cores():
    require_cuda()
    from chip_smoke import TENSOR_CORE_KERNELS, tensor_core_instructions
    from paddle_tpu_torch.ops import _kernels
    counts = _kernels.sass_instruction_counts()
    for name, opcodes in TENSOR_CORE_KERNELS.items():
        assert tensor_core_instructions(counts, name, opcodes), \
            f"no {opcodes} instruction in {name}"
        if name.startswith("flash"):
            assert any(name in k and "__half" in k for k in counts), name


def _adam_case(rng, n, pdtype, mdtype, master, offset=0):
    """p, g, m1, m2 (and the fp32 master) of n elements on the card, each a
    slice at `offset` elements into its own buffer (offset 1 misaligns
    every pointer and takes the kernel's one-element path)."""
    import numpy as np

    def buf(a, dtype):
        t = torch.zeros(n + offset, dtype=dtype, device="cuda")
        t[offset:] = torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
        return t[offset:]

    p32 = rng.standard_normal(n)
    out = dict(p=buf(p32, pdtype), g=buf(rng.standard_normal(n), pdtype),
               m1=buf(rng.standard_normal(n) * 0.1, mdtype),
               m2=buf(np.abs(rng.standard_normal(n)) * 0.01, mdtype),
               master=buf(p32, torch.float32) if master else None)
    return out


def _adam_scalars():
    f32 = dict(dtype=torch.float32, device="cuda")
    return (torch.tensor(3e-3, **f32), torch.tensor(0.9 ** 5, **f32),
            torch.tensor(0.95 ** 5, **f32))


# The kernel runs _adam_math's operations in the same order, each rounded
# once (no FMA), as PyTorch's elementwise kernels do: bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("pdtype,mdtype,master", [
    (torch.float32, torch.float32, False),
    (torch.float32, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, True),
    # fp16 (pure-fp16 training: fp16 p and g, an fp32 master and fp32
    # moments first), counted as fused_adam_fp16
    (torch.float16, torch.float32, True),
    (torch.float16, torch.float16, True),
    (torch.float16, torch.float16, False),
    (torch.float16, torch.float32, False),
    (torch.float32, torch.float16, False),
    (torch.bfloat16, torch.float16, True),
])
def test_cuda_fused_adam_matches_plain_bitwise(pdtype, mdtype, master,
                                               decoupled):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.fused_adam import (fused_adam,
                                                 fused_adam_cuda,
                                                 fused_adam_plain)
    rng = np.random.RandomState(41)
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, decoupled=decoupled)
    counter = ("fused_adam_fp16" if torch.float16 in (pdtype, mdtype)
               else "fused_adam")
    for n, offset in ((1, 0), (7, 0), (300, 0), (2049, 0), (2049, 1),
                      (1 << 20, 0)):
        c = _adam_case(rng, n, pdtype, mdtype, master, offset)
        ref = {k: None if v is None else v.clone() for k, v in c.items()}
        before = launch_counts()[counter]
        fused_adam_cuda(c["p"], c["g"], c["m1"], c["m2"], *_adam_scalars(),
                        0.1, master=c["master"], **kw)
        fused_adam_plain(ref["p"], ref["g"], ref["m1"], ref["m2"],
                         *_adam_scalars(), 0.1, master=ref["master"], **kw)
        torch.cuda.synchronize()
        assert launch_counts()[counter] == before + 1
        for k in ("p", "m1", "m2", "master"):
            if c[k] is not None:
                assert c[k].dtype == ref[k].dtype
                assert torch.equal(c[k], ref[k]), (n, offset, k)
        # the dispatching entry point takes the kernel for CUDA tensors,
        # and the same call on the same inputs gives the same bits
        again = {k: None if v is None else v.clone() for k, v in c.items()}
        twice = {k: None if v is None else v.clone() for k, v in c.items()}
        for d in (again, twice):
            fused_adam(d["p"], d["g"], d["m1"], d["m2"], *_adam_scalars(),
                       0.1, master=d["master"], **kw)
        torch.cuda.synchronize()
        assert launch_counts()[counter] == before + 3
        for k in ("p", "m1", "m2"):
            assert torch.equal(again[k], twice[k]), (n, k)


# The do_update flag: False leaves p, m1, m2 and the master bit for bit as
# they were; True and a null flag give the same bits, those of the plain
# version with the same flag; the optimizer gates the beta powers' advance
# by the same flag with a device-side where.
@pytest.mark.cuda
@pytest.mark.parametrize("pdtype,mdtype,master", [
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, True),
    (torch.float16, torch.float32, True),
])
def test_cuda_fused_adam_do_update_flag(pdtype, mdtype, master):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                 fused_adam_plain)
    rng = np.random.RandomState(42)
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, decoupled=True)
    keys = ("p", "m1", "m2", "master")
    counter = ("fused_adam_fp16" if torch.float16 in (pdtype, mdtype)
               else "fused_adam")
    for n, offset in ((7, 0), (2049, 1), (1 << 20, 0)):
        c = _adam_case(rng, n, pdtype, mdtype, master, offset)
        runs = {}
        for flag in (None, True, False):
            d = {k: None if v is None else v.clone() for k, v in c.items()}
            ref = {k: None if v is None else v.clone() for k, v in c.items()}
            f = None if flag is None else torch.tensor(flag, device="cuda")
            before = launch_counts()[counter]
            fused_adam_cuda(d["p"], d["g"], d["m1"], d["m2"],
                            *_adam_scalars(), 0.1, master=d["master"],
                            do_update=f, **kw)
            fused_adam_plain(ref["p"], ref["g"], ref["m1"], ref["m2"],
                             *_adam_scalars(), 0.1, master=ref["master"],
                             do_update=f, **kw)
            torch.cuda.synchronize()
            assert launch_counts()[counter] == before + 1
            for k in keys:
                if d[k] is not None:
                    assert torch.equal(d[k], ref[k]), (n, flag, k)
            runs[flag] = d
        for k in keys:
            if c[k] is None:
                continue
            assert torch.equal(runs[False][k], c[k]), (n, k)
            assert torch.equal(runs[True][k], runs[None][k]), (n, k)
            assert not torch.equal(runs[True][k], c[k]) or k == "g", (n, k)


# apply, skip, apply through AdamW gives the bits of apply, apply: the
# skipped step leaves the weight, both moments and both beta powers as
# they were.
@pytest.mark.cuda
def test_cuda_adam_skipped_step_keeps_beta_powers():
    require_cuda()
    from paddle_tpu_torch.optimizer import AdamW
    w = torch.nn.Parameter(torch.randn(300, device="cuda"))
    twin = torch.nn.Parameter(w.detach().clone())
    opt = AdamW(learning_rate=1e-3, parameters=[w])
    ref = AdamW(learning_rate=1e-3, parameters=[twin])
    g = torch.randn(300, device="cuda")
    opt.apply_gradients([(w, g)])
    state = {k: v.clone() for k, v in opt.state[w].items()}
    w0 = w.detach().clone()
    opt.apply_gradients([(w, g)], do_update=torch.tensor(False,
                                                         device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(w.detach(), w0)
    for k, v in opt.state[w].items():
        assert torch.equal(v, state[k]), k
    opt.apply_gradients([(w, g)], do_update=torch.tensor(True,
                                                         device="cuda"))
    for _ in range(2):
        ref.apply_gradients([(twin, g)])
    torch.cuda.synchronize()
    assert torch.equal(w.detach(), twin.detach())
    for k, v in opt.state[w].items():
        assert torch.equal(v, ref.state[twin][k]), k


@pytest.mark.cuda
def test_cuda_fused_adam_refuses_bad_inputs():
    require_cuda()
    from paddle_tpu_torch.ops.fused_adam import fused_adam_cuda
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True)
    s = _adam_scalars()
    z = torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        fused_adam_cuda(z.double(), z.double(), z, z, *s, 0.0, **kw)
    with pytest.raises(TypeError, match="master"):
        fused_adam_cuda(z, z, z, z, *s, 0.0, master=z, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        w = torch.zeros((8, 16), device="cuda").t()
        fused_adam_cuda(w, w, w, w, *s, 0.0, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_adam_cuda(z, z, z, z, torch.tensor(1e-3), s[1], s[2], 0.0,
                        **kw)
    with pytest.raises(ValueError, match="shape"):
        fused_adam_cuda(z, torch.zeros(65, device="cuda"), z, z, *s, 0.0,
                        **kw)
    with pytest.raises(TypeError, match="device memory"):
        fused_adam_cuda(z, z, z, z, 1e-3, s[1], s[2], 0.0, **kw)
    with pytest.raises(TypeError, match="master"):
        fused_adam_cuda(z, z, z, z, *s, 0.0, master=z.clone(), **kw)


# ---- where the engine's and generate()'s bf16 streams part (ROADMAP §3
# item 2). One 64-token prompt runs through the engine's unified step (8
# slots x a 64-token chunk: 512 rows a GEMM) and through generate()'s
# prefill (64 rows), then one decode step each (512 rows against 1); every
# leaf module's output (and the attention core's, the input of out_proj)
# is recorded by hooks and compared for the prompt's rows in execution
# order. The first op to differ is named in the output. A port kernel (the
# LayerNorm forward, paged attention) given equal inputs must give equal
# outputs whatever the batch around it; a cuBLAS GEMM may choose another
# algorithm by M and differ. gpt3-1.3b widths, 2 layers, bf16, random
# weights.
class _OpRecorder:
    """Inputs and outputs of every leaf module, one list per call of the
    model's transformer (`model.gpt`), in execution order."""

    def __init__(self, model):
        self.calls, self.on, self._hooks = [], False, []
        self._hooks.append(model.gpt.register_forward_pre_hook(
            lambda *_: self.calls.append([]) if self.on else None))
        for name, mod in model.named_modules():
            if not list(mod.children()):
                self._hooks.append(mod.register_forward_hook(
                    self._hook(name)))

    def _hook(self, name):
        def record(_mod, args, out):
            if not self.on or not torch.is_tensor(out):
                return
            arg = args[0] if args and torch.is_tensor(args[0]) else None
            self.calls[-1].append((name, None if arg is None
                                   else arg.detach().clone(),
                                   out.detach().clone()))
        return record

    def remove(self):
        for h in self._hooks:
            h.remove()


def _first_differing_op(eng_ops, gen_ops, row, cols):
    """(report of the first op whose output differs for the prompt's
    rows, ops compared). Tensors of another rank on the two sides (the
    decode step's position ids) are not compared."""
    assert [n for n, _, _ in eng_ops] == [n for n, _, _ in gen_ops]

    def same(e, g):
        if e is None or g is None or e.ndim != g.ndim or e.ndim < 2:
            return None
        return torch.equal(e[row, cols], g[0, cols])

    for (name, ei, eo), (_, gi, go) in zip(eng_ops, gen_ops):
        checks = [("output", eo, go, same(ei, gi))]
        if name.endswith("out_proj"):       # the attention core's output
            checks.insert(0, ("attention core output", ei, gi, True))
        for what, e, g, inputs_equal in checks:
            if same(e, g) is False:
                diff = (e[row, cols].float() - g[0, cols].float()).abs()
                return dict(op=name, what=what,
                            max_abs_diff=float(diff.max()),
                            inputs_equal=inputs_equal), len(eng_ops)
    return None, len(eng_ops)


@pytest.mark.cuda
def test_cuda_engine_and_generate_first_differing_op():
    require_cuda()
    import json
    import numpy as np
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                       dtype="bfloat16", generator=gen,
                                       num_hidden_layers=2)
    model.eval()
    prompt = np.random.RandomState(1).randint(0, 50304, (64,)).astype(
        np.int32)
    rec = _OpRecorder(model)
    try:
        eng = LLMEngine(model, LLMEngineConfig(
            num_slots=8, block_len=8, n_blocks=64, prefill_chunk=64,
            max_new_tokens=2), clock=SimClock())
        eng.submit(prompt, max_new_tokens=2)
        rec.on = True
        eng.pump()                       # prefill: the whole 64-token chunk
        eng.pump()                       # one decode step
        rec.on = False
        eng_calls = rec.calls
        rec.calls = []
        rec.on = True
        generate(model, prompt[None], max_new_tokens=2)
        rec.on = False
        gen_calls = rec.calls
    finally:
        rec.remove()
    assert len(eng_calls) == 2 and len(gen_calls) == 2
    ids = next(i for n, i, _ in eng_calls[0]
               if n.endswith("word_embeddings"))   # the step's tokens [N, C]
    want = torch.from_numpy(prompt).to(ids.device, ids.dtype)
    row = next(r for r in range(ids.shape[0]) if torch.equal(ids[r], want))
    findings = {}
    for step, cols in (("prefill", slice(0, 64)), ("decode", slice(0, 1))):
        i = 0 if step == "prefill" else 1
        first, n = _first_differing_op(eng_calls[i], gen_calls[i], row, cols)
        findings[step] = dict(ops_compared=n, first_differing=first)
    print("engine_vs_generate " + json.dumps(findings))
    for step, f in findings.items():
        first = f["first_differing"]
        if first is None:
            continue
        assert first["inputs_equal"], (step, first)
        # a port kernel with equal inputs must not be the one that differs
        port_kernel = (first["what"] == "attention core output"
                       or "norm" in first["op"])
        assert not port_kernel, (step, first)


# MoE (ernie-moe-base widths): the layer on the card against the same
# layer on the CPU, fp32 (TF32 off) — output and every gradient within
# 1e-4 of the leaf's largest (sums of 768 or 3072 products in another
# order), aux within 1e-5, and the routing equal where no two gates of a
# choice lie within 1e-6 (chip_smoke.MOE_MARGIN_TOL); nothing in it
# launches a port kernel. Then one bf16 train step of ernie-moe-base's
# widths cut to 2 layers at 8 x 1024 routes attention to the flash
# kernels at head dim 64 (2 forward, 2 dq, 2 dk/dv, the bf16 tensor-core
# instantiations, no fp16 one), the LayerNorms to theirs (5 and 5) and
# the update to fused Adam, one launch a leaf (30).
@pytest.mark.cuda
def test_cuda_moe_layer_matches_cpu():
    require_cuda()
    import numpy as np
    from chip_smoke import MOE_MARGIN_TOL, route_mismatches
    from paddle_tpu_torch.nn.layer.moe import MoELayer
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = MoELayer(768, 3072, 8, top_k=2, device="cpu")
    with torch.no_grad():
        cpu.reset_parameters(torch.Generator().manual_seed(5))
    card = MoELayer(768, 3072, 8, top_k=2, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal((2, 256, 768)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 256, 768)).astype(
        np.float32))
    xc = x.clone().requires_grad_()
    xg = x.cuda().requires_grad_()
    reset_launch_counts()
    out_g = card(xg)
    torch.autograd.backward([out_g, card.aux_loss], [g.cuda(),
                                                     torch.tensor(0.5).cuda()])
    torch.cuda.synchronize()
    assert not any(launch_counts().values()), launch_counts()
    out_c = cpu(xc)
    torch.autograd.backward([out_c, cpu.aux_loss], [g, torch.tensor(0.5)])
    diff, slots_equal, kept_equal = route_mismatches(torch, card.routing,
                                                     cpu.routing)
    assert all(m < MOE_MARGIN_TOL for _, _, m in diff), diff
    if not diff:
        assert slots_equal and kept_equal
    assert abs(float(card.aux_loss.detach())
               - float(cpu.aux_loss.detach())) <= 1e-5
    pairs = [("out", out_g.detach(), out_c.detach()), ("x", xg.grad, xc.grad)]
    pairs += [(k, p.grad, dict(cpu.named_parameters())[k].grad)
              for k, p in card.named_parameters()]
    for k, a, b in pairs:
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(scale, 1.0), k


@pytest.mark.cuda
def test_cuda_moe_train_step_routes_to_kernels():
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    m = GPTForCausalLM.from_preset("ernie-moe-base", num_hidden_layers=2,
                                   dtype="bfloat16")
    m.train()
    step = ShardedTrainStep(m, AdamW(learning_rate=1e-4,
                                     parameters=m.parameters()))
    ids = np.random.RandomState(4).randint(0, 50304, (8, 1024)).astype(
        np.int32)
    reset_launch_counts()
    loss = step(ids, ids)
    torch.cuda.synchronize()
    n = launch_counts()
    assert torch.isfinite(loss)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert n[k] == 2 and n[k + "_fp16"] == 0, (k, n)
    assert n["layernorm_fwd"] == 5 and n["layernorm_bwd"] == 5
    assert n["fused_adam"] == sum(1 for _ in m.parameters()) == 30
    assert m.gpt.layers[1].moe.routing[0].shape == (8192, 2)


@pytest.mark.cuda
def test_cuda_resnet18_train_step_matches_cpu():
    require_cuda()
    # resnet18 (1000 classes) on the card against its CPU twin: a float64
    # and an fp32 forward and backward, then one AdamW step, held to the
    # resnet_model phase's limits; one fused-Adam launch a leaf
    from chip_smoke import (RESNET_BUFFER_TOL, RESNET_FP32_GRAD_RTOL,
                            RESNET_FP64_BUFFER_TOL, RESNET_FP64_GRAD_RTOL,
                            RESNET_FP64_LOGITS_TOL, RESNET_LOGITS_TOL,
                            RESNET_PARAM_SHARE, TRAIN_PARITY_LOSS_TOL,
                            TRAIN_PARITY_LR, resnet_card_vs_cpu)
    r = resnet_card_vs_cpu(depth=18, batch=(8, 64), steps=1)
    assert r["leaves"] == 62
    assert r["kernel_launches"]["fused_adam"] == 62
    assert sum(r["kernel_launches"].values()) == 62
    f64, f32, (st,) = r["fp64"], r["fp32"], r["steps"]
    assert f64["logits_max_abs_diff"] <= RESNET_FP64_LOGITS_TOL, f64
    assert f64["grad_norm_max_rel_diff"] <= RESNET_FP64_GRAD_RTOL, f64
    assert f64["buffer_max_rel_diff"] <= RESNET_FP64_BUFFER_TOL, f64
    assert f32["logits_max_abs_diff"] <= RESNET_LOGITS_TOL, f32
    assert f32["loss_abs_diff"] <= TRAIN_PARITY_LOSS_TOL, f32
    assert f32["grad_norm_max_rel_diff"] <= RESNET_FP32_GRAD_RTOL, f32
    assert f32["buffer_max_rel_diff"] <= RESNET_BUFFER_TOL, f32
    assert st["loss_abs_diff"] <= TRAIN_PARITY_LOSS_TOL, st
    assert st["param_max_abs_diff"] <= 6 * TRAIN_PARITY_LR, st
    assert st["param_share_past_lr_over_10"] <= RESNET_PARAM_SHARE, st
    assert st["buffer_max_rel_diff"] <= RESNET_BUFFER_TOL, st


@pytest.mark.cuda
def test_cuda_bf16_batch_norm_keeps_fp32_statistics():
    require_cuda()
    from chip_smoke import check_bf16_batch_norm
    r = check_bf16_batch_norm(shape=(8, 64, 28, 28))
    assert all(v <= 1.0 for k, v in r.items()
               if k.endswith("_max_over_limit")), r
