"""The port's threefry (paddle_tpu_torch/core/threefry.py) against
jax.random, on the CPU.

Keys, folds, splits and random bits must equal JAX's bit for bit, and so
must `uniform`; `gumbel` takes one inexact step (`log`), so it is held
within 2 fp32 ulps (of max(|g|, 1), see `gumbel_ulps`), and
`categorical` must pick JAX's tokens. Seeds cover
0, 1, 2^31 - 1 and random ones; shapes a vocabulary row [V], a batch
[B, V] and a unified step's [N*C, V]. JAX's default
`jax_threefry_partitionable = True` is what the port reproduces, so the
flag's value is asserted: a JAX that flips it fails here loudly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import threefry

SEEDS = [0, 1, 2 ** 31 - 1] + [int(s) for s in
                              np.random.RandomState(9).randint(0, 2 ** 31,
                                                               3)]
SHAPES = [(512,), (4, 512), (4 * 16, 512)]
TINY = float(np.finfo(np.float32).tiny)


def _key(seed):
    return jax.random.PRNGKey(seed), threefry.prng_key(seed)


def _eq(jax_arr, port):
    np.testing.assert_array_equal(
        np.asarray(jax_arr).astype(np.int64), port.numpy())


def test_jax_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True


def test_threefry2x32_known_answer():
    """Random123's known-answer vector for Threefry-2x32-20 (key and
    counter all ones bits), which XLA's kernel reproduces."""
    m = torch.tensor([0xFFFFFFFF], dtype=torch.int64)
    y1, y2 = threefry.threefry2x32(m, m, m, m)
    assert (int(y1), int(y2)) == (0x1CB996FC, 0xBB002BE7)
    z = torch.zeros(1, dtype=torch.int64)
    y1, y2 = threefry.threefry2x32(z, z, z, z)
    assert (int(y1), int(y2)) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    jk, tk = _key(seed)
    _eq(jk, tk)
    for d in (0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1):
        _eq(jax.random.fold_in(jk, d), threefry.fold_in(tk, d))
    for n in (2, 3, 16):
        _eq(jax.random.split(jk, n), threefry.split(tk, n))
    # a batch of keys folds a batch of data (JAX's vmap)
    data = np.arange(0, 9000, 1000, dtype=np.uint32)
    jb = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.asarray(data))
    _eq(jb, threefry.fold_in(tk, torch.from_numpy(data.astype(np.int64))))
    sub = jax.random.split(jk, 4)
    _eq(jax.vmap(lambda k: jax.random.split(k, 3))(sub),
        threefry.split(threefry.split(tk, 4), 3))


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_key(seed):
    from paddle_tpu.serving.llm.sampling import lane_key as jax_lane
    from paddle_tpu_torch.serving.llm.sampling import lane_key
    idx = np.array([0, 1, 31, 4096, 2 ** 31 - 1], np.int32)
    seeds = np.full(idx.shape, seed, np.int32)
    want = jax.vmap(jax_lane)(jnp.asarray(seeds), jnp.asarray(idx))
    _eq(want, lane_key(torch.from_numpy(seeds), torch.from_numpy(idx)))
    _eq(jax_lane(seed, 5), lane_key(seed, 5))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_random_bits_and_uniform(seed, shape):
    jk, tk = _key(seed)
    _eq(jax.random.bits(jk, shape, jnp.uint32),
        threefry.random_bits(tk, shape))
    for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.5, 4.0)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                             maxval=hi))
        got = threefry.uniform(tk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_random_bits_per_row_keys():
    """A [B, 2] batch of keys draws one row each, as vmap(bits) does."""
    jk, tk = _key(42)
    keys = jax.random.split(jk, 6)
    want = jax.vmap(lambda k: jax.random.bits(k, (512,), jnp.uint32))(keys)
    _eq(want, threefry.random_bits(threefry.split(tk, 6), (512,)))


def test_uniform_zero_bits_give_tiny(monkeypatch):
    """Mantissa bits of 0 map to u = minval = tiny, so gumbel's inner log
    never sees 0; a key whose draw has them is rare, so the bits are
    planted."""
    bits = torch.tensor([0, 511, 512, 0xFFFFFFFF], dtype=torch.int64)
    monkeypatch.setattr(threefry, "random_bits", lambda key, shape: bits)
    u = threefry.uniform(threefry.prng_key(0), (4,), TINY, 1.0)
    assert u.tolist() == [np.float32(TINY), np.float32(TINY), 2.0 ** -23,
                          1.0 - 2.0 ** -23]
    assert torch.isfinite(threefry.gumbel(threefry.prng_key(0), (4,))).all()


def gumbel_ulps(got, want):
    """|got - want| in fp32 ulps of max(|want|, 1). The noise is
    -log(L) with L = -log(u): L's one-ulp error (2^-23 of L) becomes an
    absolute error of 2^-23 in the result, which is one ulp at |g| = 1
    and many ulps of a value near 0, where the noise crosses zero."""
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    return np.abs(got.astype(np.float64) - want) / scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_within_two_ulps(seed, shape):
    jk, tk = _key(seed)
    want = np.asarray(jax.random.gumbel(jk, shape))
    got = threefry.gumbel(tk, shape).numpy()
    assert got.dtype == np.float32
    assert gumbel_ulps(got, want).max() <= 2


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_tokens_equal(seed):
    rng = np.random.RandomState(seed % 1000)
    jk, tk = _key(seed)
    lg = (rng.standard_normal((16, 512)) * 2).astype(np.float32)
    lg[:, 100:200] = -1e30                     # a filtered-out band
    want = jax.random.categorical(jk, jnp.asarray(lg))
    _eq(want, threefry.categorical(tk, torch.from_numpy(lg)))
    keys = jax.random.split(jk, 16)            # one key a row
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(lg))
    _eq(want, threefry.categorical(threefry.split(tk, 16),
                                   torch.from_numpy(lg)))
