"""Ragged paged attention in the PyTorch port against the JAX package.

The port's plain version (`paged_attention_plain`, the CPU path) is held
to the JAX `ragged_paged_attention` both through its XLA scan and
through the real Pallas kernel in interpret mode, at atol/rtol 1e-5 in
fp32 (the same op sequence, sums taken in another order). Inputs: page
tables that share pages between rows and pad with -1, ragged lengths,
q_pos > 0, prefill-chunk and decode rows, GQA. (The CUDA kernel is held
to the plain version on the card in test_torch_cuda_kernels.py.)
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import paged_inputs as _inputs

TOL = dict(atol=1e-5, rtol=1e-5)


def _port(c, dtype=torch.float32):
    from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention
    t = lambda a: torch.from_numpy(a).to(dtype)     # noqa: E731
    out = ragged_paged_attention(
        t(c["q"]), t(c["k"]), t(c["v"]), torch.from_numpy(c["table"]),
        torch.from_numpy(c["lens"]), torch.from_numpy(c["q_pos"]),
        block_len=c["bl"], pages_per_row=c["ppr"])
    return out.float().numpy()


def _jax(c, impl, dtype=jnp.float32):
    from paddle_tpu.ops.paged_attention import ragged_paged_attention
    a = lambda x: jnp.asarray(x, dtype)              # noqa: E731
    out = ragged_paged_attention(
        a(c["q"]), a(c["k"]), a(c["v"]), c["table"], c["lens"], c["q_pos"],
        block_len=c["bl"], pages_per_row=c["ppr"], impl=impl)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", [
    dict(seed=0),                                          # GQA 4:2
    dict(seed=1, H=2, Hkv=2, lens=(20, 1, 7), Tq=1,
         decode_rows=(0, 1, 2)),                           # decode rows
    dict(seed=2, H=4, Hkv=1, Tq=9, lens=(12, 5, 20)),      # MQA, Tq > bl
])
def test_plain_matches_jax_scan(case):
    c = _inputs(**case)
    np.testing.assert_allclose(_port(c), _jax(c, "scan"), **TOL)


def test_plain_matches_jax_pallas_interpret():
    """The real TPU kernel body, run in interpret mode on the CPU."""
    from paddle_tpu.ops.paged_attention import _HAS_PALLAS
    assert _HAS_PALLAS
    c = _inputs(7)
    np.testing.assert_allclose(_port(c), _jax(c, "pallas_interpret"), **TOL)


def test_bf16_plain_matches_jax_scan():
    """bf16 caches: both round p to bf16 before PV and the output once;
    one bf16 ulp at |out| < 4 is 2^-6."""
    c = _inputs(3)
    np.testing.assert_allclose(_port(c, torch.bfloat16),
                               _jax(c, "scan", jnp.bfloat16),
                               atol=2 ** -6, rtol=0)


def test_fp16_plain_matches_jax_pallas_interpret_and_scan():
    """fp16 caches (fp16 serving): the Pallas kernel in interpret mode and
    the XLA scan both round p to fp16 before PV and the output once, as
    the port does; one fp16 ulp at |out| < 4 is 2^-9."""
    c = _inputs(4)
    got = _port(c, torch.float16)
    for impl in ("pallas_interpret", "scan"):
        np.testing.assert_allclose(got, _jax(c, impl, jnp.float16),
                                   atol=2 ** -9, rtol=0)


def test_decode_attention_scalar_and_vector_pos():
    from paddle_tpu.ops.attention import decode_attention as jax_decode
    from paddle_tpu_torch.ops.attention import decode_attention
    rng = np.random.RandomState(11)
    B, H, Hkv, T, D, L = 2, 4, 2, 3, 8, 21       # L not a multiple of 8
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    f = torch.from_numpy
    for pos, tpos in ((5, 5), (np.array([2, 15], np.int32),
                               torch.tensor([2, 15], dtype=torch.int32))):
        ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos)))
        out = decode_attention(f(q), f(k), f(v), tpos).numpy()
        np.testing.assert_allclose(out, ref, **TOL)


def test_update_kv_cache_matches_jax_including_clamp():
    """dynamic_update_slice clamps a start that would overrun the cache;
    the port's indexed write lands in the same columns."""
    from paddle_tpu.ops.attention import update_kv_cache as jax_update
    from paddle_tpu_torch.ops.attention import update_kv_cache
    rng = np.random.RandomState(12)
    B, Hkv, L, T, D = 3, 2, 10, 4, 5
    kc = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    for pos in (3, 8, np.array([0, 4, 9], np.int32)):   # 8, 9 clamp to 6
        jk, jv = jax_update(jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(pos))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        tk, tv = update_kv_cache(torch.from_numpy(kc.copy()),
                                 torch.from_numpy(vc.copy()),
                                 torch.from_numpy(kn), torch.from_numpy(vn),
                                 tpos)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_trivial_block_table_matches_jax():
    from paddle_tpu.ops.paged_attention import \
        trivial_block_table as jax_table
    from paddle_tpu_torch.ops.paged_attention import trivial_block_table
    for B, L, bl in ((3, 21, 8), (2, 16, 8), (1, 5, 4)):
        jt, jnb = jax_table(B, L, bl)
        tt, tnb = trivial_block_table(B, L, bl)
        assert jnb == tnb
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_chunked_prefill_bitwise_equals_whole_prompt():
    """Chunk invariance inside the port: at a fixed block_len a query row's
    output depends only on its absolute position and the committed KV, so
    chunked outputs equal the whole-prompt call bit for bit."""
    from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention
    rng = np.random.RandomState(5)
    H, Hkv, D, bl, nb, L = 2, 2, 8, 8, 3, 20
    k = torch.from_numpy(rng.standard_normal((1, Hkv, nb * bl, D))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, Hkv, nb * bl, D))
                         .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, H, L, D))
                         .astype(np.float32))
    table = torch.arange(nb, dtype=torch.int32)[None]
    whole = ragged_paged_attention(q, k, v, table, torch.tensor([L]),
                                   torch.tensor([0]), block_len=bl)
    C = 8
    for off in range(0, L, C):
        n = min(C, L - off)
        qc = torch.zeros((1, H, C, D))
        qc[:, :, :n] = q[:, :, off:off + n]
        out = ragged_paged_attention(qc, k, v, table,
                                     torch.tensor([off + n]),
                                     torch.tensor([off]), block_len=bl)
        assert torch.equal(out[:, :, :n], whole[:, :, off:off + n]), \
            f"chunk at offset {off} diverged from whole-prompt prefill"
