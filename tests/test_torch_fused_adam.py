"""The port's fused Adam (`ops/fused_adam.py`) against the JAX package's.

The JAX side runs `fused_adam(..., force_pallas=True)`: the Pallas kernel
`_adam_kernel` in interpret mode for n >= 1024 (its XLA tail epilogue for
the ragged rest), the plain XLA formula for n = 300. bf16 moments are
widened to fp32 around the JAX call and rounded back after it, as the JAX
`Adam._rule` does; the port reads and writes them in place. The port runs
on CPU tensors, so `fused_adam` takes its plain version (`adam_math`
applied in place); on the card the kernel is held to that plain version
bit for bit (`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`).

Tolerance: fp32 outputs atol = rtol = 1e-6 (the same op sequence; a
square root or quotient may round one ulp apart); bf16 outputs within one
bf16 ulp (+ 1e-7) of the JAX value (both round one fp32 value once).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import ulp_bf16, ulp_fp16

LR, B1, B2, EPS, WD = 1e-3, 0.9, 0.999, 1e-8, 0.01
B1P, B2P = 0.9 ** 3, 0.999 ** 3


def _inputs(n, seed=4):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            (rng.standard_normal(n) * 0.1).astype(np.float32),
            (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32))


def _close(got, want, bf16):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if bf16:
        big = np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= ulp_bf16(big) + 1e-7).all(), \
            float(np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _scalars():
    return (torch.tensor(LR), torch.tensor(B1P, dtype=torch.float32),
            torch.tensor(B2P, dtype=torch.float32))


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 2049, 300])
def test_fused_adam_matches_jax_pallas(n, pdtype, moments, decoupled):
    from paddle_tpu.ops.fused_adam import fused_adam as jax_fused_adam
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.fused_adam import fused_adam
    p, g, m1, m2 = _inputs(n)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jp, jg = (jnp.asarray(a, jdt[pdtype]) for a in (p, g))
    jm1, jm2 = (jnp.asarray(a, jdt[moments]) for a in (m1, m2))
    want_p, want_m1, want_m2 = jax_fused_adam(
        jp, jg, jm1.astype(jnp.float32), jm2.astype(jnp.float32), LR, B1P,
        B2P, WD, beta1=B1, beta2=B2, epsilon=EPS, decoupled=decoupled,
        force_pallas=True)
    want_m1, want_m2 = want_m1.astype(jdt[moments]), \
        want_m2.astype(jdt[moments])
    tp, tg = (torch.from_numpy(a).to(pdtype) for a in (p, g))
    tm1, tm2 = (torch.from_numpy(a).to(moments) for a in (m1, m2))
    before = launch_counts()
    out = fused_adam(tp, tg, tm1, tm2, *_scalars(), WD, beta1=B1, beta2=B2,
                     epsilon=EPS, decoupled=decoupled)
    assert launch_counts() == before            # CPU tensors: plain version
    assert out[0] is tp and out[1] is tm1 and out[2] is tm2   # in place
    assert tp.dtype == pdtype and tm1.dtype == tm2.dtype == moments
    _close(tp, want_p, pdtype == torch.bfloat16)
    _close(tm1, want_m1, moments == torch.bfloat16)
    _close(tm2, want_m2, moments == torch.bfloat16)


@pytest.mark.parametrize("decoupled", [False, True])
def test_fused_adam_master_weight_matches_jax(decoupled):
    """multi_precision: the JAX `_rule_mp` updates the fp32 master through
    fused_adam and writes the bf16 parameter from it; the port does both in
    one call."""
    from paddle_tpu.ops.fused_adam import fused_adam as jax_fused_adam
    from paddle_tpu_torch.ops.fused_adam import fused_adam
    p, g, m1, m2 = _inputs(2049, seed=5)
    new_master, want_m1, want_m2 = jax_fused_adam(
        jnp.asarray(p), jnp.asarray(g, jnp.bfloat16), jnp.asarray(m1),
        jnp.asarray(m2), LR, B1P, B2P, WD, beta1=B1, beta2=B2, epsilon=EPS,
        decoupled=decoupled, force_pallas=True)
    master = torch.from_numpy(p.copy())
    tp = master.to(torch.bfloat16)
    tm1, tm2 = torch.from_numpy(m1), torch.from_numpy(m2)
    fused_adam(tp, torch.from_numpy(g).to(torch.bfloat16), tm1, tm2,
               *_scalars(), WD, beta1=B1, beta2=B2, epsilon=EPS,
               decoupled=decoupled, master=master)
    _close(master, new_master, False)
    _close(tp, new_master.astype(jnp.bfloat16), True)
    _close(tm1, want_m1, False)
    _close(tm2, want_m2, False)


def _close_fp16(got, want):
    """fp16 outputs within one fp16 ulp (+ 1e-7) of the JAX value: both
    round one fp32 value once."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    big = np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= ulp_fp16(big) + 1e-7).all(), \
        float(np.abs(got - want).max())


_DT = {torch.float32: jnp.float32, torch.float16: jnp.float16}


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("pdtype,moments", [
    (torch.float16, torch.float16), (torch.float16, torch.float32),
    (torch.float32, torch.float16)])
def test_fp16_fused_adam_matches_jax_pallas(pdtype, moments, decoupled):
    """fp16 p and g, fp16 moments, or both (the JAX kernel takes any float
    dtype and computes in fp32), the Pallas kernel in interpret mode with
    its XLA tail (n = 2049); fp32 outputs at 1e-6, fp16 ones within one
    fp16 ulp."""
    from paddle_tpu.ops.fused_adam import fused_adam as jax_fused_adam
    from paddle_tpu_torch.ops.fused_adam import fused_adam
    p, g, m1, m2 = _inputs(2049, seed=6)
    jp, jg = (jnp.asarray(a, _DT[pdtype]) for a in (p, g))
    jm1, jm2 = (jnp.asarray(a, _DT[moments]) for a in (m1, m2))
    want_p, want_m1, want_m2 = jax_fused_adam(
        jp, jg, jm1.astype(jnp.float32), jm2.astype(jnp.float32), LR, B1P,
        B2P, WD, beta1=B1, beta2=B2, epsilon=EPS, decoupled=decoupled,
        force_pallas=True)
    tp, tg = (torch.from_numpy(a).to(pdtype) for a in (p, g))
    tm1, tm2 = (torch.from_numpy(a).to(moments) for a in (m1, m2))
    fused_adam(tp, tg, tm1, tm2, *_scalars(), WD, beta1=B1, beta2=B2,
               epsilon=EPS, decoupled=decoupled)
    assert tp.dtype == pdtype and tm1.dtype == tm2.dtype == moments
    for got, want, dt in ((tp, want_p, pdtype), (tm1, want_m1, moments),
                          (tm2, want_m2, moments)):
        if dt == torch.float16:
            _close_fp16(got, want.astype(jnp.float16))
        else:
            _close(got, want, False)


@pytest.mark.parametrize("decoupled", [False, True])
def test_fp16_fused_adam_master_weight_matches_jax(decoupled):
    """multi_precision beside an fp16 parameter (pure-fp16 training): the
    fp32 master updated by fused_adam, the fp16 parameter written from it
    (one rounding), fp32 moments."""
    from paddle_tpu.ops.fused_adam import fused_adam as jax_fused_adam
    from paddle_tpu_torch.ops.fused_adam import fused_adam
    p, g, m1, m2 = _inputs(2049, seed=7)
    new_master, want_m1, want_m2 = jax_fused_adam(
        jnp.asarray(p), jnp.asarray(g, jnp.float16), jnp.asarray(m1),
        jnp.asarray(m2), LR, B1P, B2P, WD, beta1=B1, beta2=B2, epsilon=EPS,
        decoupled=decoupled, force_pallas=True)
    master = torch.from_numpy(p.copy())
    tp = master.to(torch.float16)
    tm1, tm2 = torch.from_numpy(m1), torch.from_numpy(m2)
    fused_adam(tp, torch.from_numpy(g).to(torch.float16), tm1, tm2,
               *_scalars(), WD, beta1=B1, beta2=B2, epsilon=EPS,
               decoupled=decoupled, master=master)
    _close(master, new_master, False)
    _close_fp16(tp, new_master.astype(jnp.float16))
    _close(tm1, want_m1, False)
    _close(tm2, want_m2, False)
