"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seed and handed to both packages;
the JAX package runs on the CPU, the port with device="cpu" (its plain
versions). Tests of the CUDA kernels call `require_cuda()` first, which
decides inside the test whether there is a card. This module imports no
JAX at its top, so the CUDA tests also run where only PyTorch exists.
"""
import numpy as np
import pytest

_TINY_JAX = {}


def require_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(its plain version is tested against the JAX package "
                    "instead)")


def tiny_models():
    """(jax_model, port_model) gpt2-tiny pair with the JAX weights bridged
    into the port. The JAX model is built once per process (seed 0)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    if "gpt2-tiny" not in _TINY_JAX:
        paddle.seed(0)
        _TINY_JAX["gpt2-tiny"] = JaxGPT.from_preset("gpt2-tiny")
    jm = _TINY_JAX["gpt2-tiny"]
    params, _ = jm.functional_state()
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


def paged_inputs(seed, B=3, H=4, Hkv=2, Tq=6, D=16, bl=4, ppr=5, N=3,
                 pad=3, lens=(17, 9, 4), decode_rows=(1,)):
    """Slabs [N, Hkv, ppr*bl + pad, D], a table whose rows share pages
    (row 1 reuses row 0's first two pages) and pad with -1 past each
    row's length, q_pos = len - Tq for prefill rows, len - 1 for decode."""
    rng = np.random.RandomState(seed)
    L = ppr * bl + pad
    k = rng.standard_normal((N, Hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, L, D)).astype(np.float32)
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    nb = ppr
    pages = rng.permutation(N * ppr).astype(np.int32)
    table = np.full((B, nb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // bl)
        table[b, :used] = pages[b * nb:b * nb + used]
    table[1, :2] = table[0, :2]            # shared pages across rows
    q_pos = np.array([max(n - 1, 0) if b in decode_rows else max(n - Tq, 0)
                      for b, n in enumerate(lens)], np.int32)
    return dict(q=q, k=k, v=v, table=table,
                lens=np.asarray(lens, np.int32), q_pos=q_pos, bl=bl,
                ppr=ppr)


def layernorm_inputs(seed, shape, n):
    """x [shape] ~ N(0.5, 9), weight and bias [n] ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    w = rng.standard_normal((n,)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    return x, w, b


def ulp_bf16(a):
    """One bf16 unit in the last place at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a.astype(np.float32)), np.float32(1.2e-38))
    return np.exp2(np.floor(np.log2(a)) - 7)


def train_batches(seed, K=3, B=2, S=64, vocab=512):
    """[K, B, S] token ids and next-token labels with ignored (-100)
    tokens: each row's last label and the first 7 of row 0."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (K, B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2)
    labels[:, :, -1] = -100
    labels[:, 0, :7] = -100
    return ids, labels


def train_models(**overrides):
    """A fresh JAX gpt2-tiny (seed 0) and the port model with its weights,
    both built with the GPTConfig `overrides`, the port's in train mode."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    paddle.seed(0)
    jm = JaxGPT.from_preset("gpt2-tiny", **overrides)
    params, _ = jm.functional_state()
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu", **overrides)
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()})
    tm.train()
    return jm, tm


def one_cpu_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _key_bias(name, d, n_heads=4):
    """The key columns of a qkv bias ([head][q | k | v] x head_dim)."""
    if not name.endswith("qkv_proj.bias"):
        return np.zeros(d.shape, bool)
    mask = np.zeros((n_heads, 3, d.size // (3 * n_heads)), bool)
    mask[:, 1] = True
    return mask.reshape(d.shape)


def assert_params_match(jax_params, tm, steps, lr=1e-3):
    """The port model's parameters against a JAX train step's, to the
    limits tests/test_torch_train_step.py states and explains: every
    element within 2 x lr x steps; outside the key part of the qkv biases
    at most 1e-4 of the elements more than 1e-5 apart."""
    from paddle_tpu_torch.bridge import export_state
    got = export_state(tm)
    assert set(got) == set(jax_params)
    far = total = 0
    for k, v in jax_params.items():
        d = np.abs(got[k] - np.asarray(v, np.float32))
        assert d.max() <= 2 * lr * steps, (k, float(d.max()))
        rest = d[~_key_bias(k, d)]
        far += int((rest > 1e-5).sum())
        total += rest.size
    assert far <= 1e-4 * total, (far, total)



def assert_bf16_attention_close(out, ref):
    """bf16 paged attention against its plain version, to the limits that
    chip_smoke.py states and explains beside its BF16_PA_* constants:
    every element within BF16_PA_ULPS bf16 ulps of the larger magnitude +
    BF16_PA_ATOL, and at most BF16_PA_SHARE of them past one ulp."""
    from chip_smoke import BF16_PA_ATOL, BF16_PA_SHARE, BF16_PA_ULPS
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out - ref)
    ulp = ulp_bf16(np.maximum(np.abs(out), np.abs(ref)))
    excess = float((err - BF16_PA_ULPS * ulp).max())
    assert excess <= BF16_PA_ATOL, \
        f"an element is {excess} past {BF16_PA_ULPS} bf16 ulps"
    share = float((err > ulp).mean())
    assert share <= BF16_PA_SHARE, \
        f"{share} of the elements are more than one bf16 ulp apart"
