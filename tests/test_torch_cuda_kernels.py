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
once; near y = 0 the fp32 difference itself survives). The training
kernels (flash attention forward, dq, dk/dv; LayerNorm backward): fp32
atol/rtol 1e-5 for outputs of one op sequence, 1e-4 for sums of many
products in another order; bf16 within `chip_smoke.py`'s
BF16_TRAIN_FACTOR times the bf16 plain version's own error from the fp32
plain version, plus BF16_TRAIN_ATOL. Their sums run in a fixed order, so
two runs are bit-equal, which is tested too.
"""
import pytest
import torch

from _torch_port import assert_bf16_attention_close, layernorm_inputs, \
    paged_inputs, require_cuda, ulp_bf16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,D,bl", [
    (torch.float32, 4, 2, 128, 8),
    (torch.float32, 8, 2, 64, 32),
    (torch.bfloat16, 16, 16, 128, 8),
])
def test_cuda_paged_attention_matches_plain(dtype, H, Hkv, D, bl):
    require_cuda()
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain,
                                                      ragged_paged_attention)
    c = paged_inputs(21, H=H, Hkv=Hkv, D=D, bl=bl, Tq=64)
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


# The kernel computes each query row alone, walking the blocks in table
# order, so a row's output does not depend on the chunk (or the q tile) it
# arrives in: chunked prefill equals the whole prompt bit for bit, the
# contract that makes engine streams equal generate().
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chunked_prefill_bitwise_equals_whole_prompt(dtype):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops.paged_attention import paged_attention_cuda
    rng = np.random.RandomState(8)
    H, D, bl, nb, L, C = 4, 128, 8, 12, 90, 64
    k, v = (torch.from_numpy(rng.standard_normal((1, H, nb * bl, D))
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,N", [
    (torch.float32, 512, 2048), (torch.bfloat16, 512, 2048),
    (torch.float32, 3, 8192), (torch.float32, 5, 1000),
])
def test_cuda_layernorm_matches_plain(dtype, R, N):
    require_cuda()
    from paddle_tpu_torch.ops.layernorm import (layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    x, w, b = (torch.from_numpy(a).to("cuda", dtype)
               for a in layernorm_inputs(4, (R, N), N))
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
    (torch.bfloat16, 1, 4, 190, 70, 64, False),
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
    out, lse = flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    delta = flash_attention_delta(g, out)
    runs = [(flash_bwd_dq_cuda(q, k, v, g, lse, delta, True, 128 ** -0.5),
             *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True, 128 ** -0.5))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,N", [
    (torch.float32, 4096, 2048), (torch.bfloat16, 4096, 2048),
    (torch.float32, 3, 8192), (torch.float32, 5, 1000),
    (torch.float32, 70001, 64),
])
def test_cuda_layernorm_backward_matches_plain(dtype, R, N):
    require_cuda()
    import numpy as np
    from paddle_tpu_torch.ops.layernorm import (fused_layer_norm,
                                                layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    x, w, b = (torch.from_numpy(a).to("cuda", dtype)
               for a in layernorm_inputs(5, (R, N), N))
    dy = _t(np.random.RandomState(6), (R, N), dtype)
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


@pytest.mark.cuda
def test_cuda_flash_refuses_mask_dropout_and_bad_inputs():
    require_cuda()
    from paddle_tpu_torch.ops.attention import flash_attention, \
        flash_fwd_cuda
    q = torch.zeros((1, 2, 8, 64), device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, q, q, mask=torch.zeros((1, 1, 8, 8),
                                                  device="cuda"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd_cuda(torch.zeros((1, 2, 8, 40), device="cuda"),
                       torch.zeros((1, 2, 8, 40), device="cuda"),
                       torch.zeros((1, 2, 8, 40), device="cuda"), True, 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        flash_fwd_cuda(q, q.bfloat16(), q, True, 1.0)
