"""Threefry-2x32 random bits, bit for bit as `jax.random` makes them.

The port's counterpart of the part of `jax.random` the JAX package calls
for sampling (`PRNGKey`, `fold_in`, `split`, `bits`, `uniform`, `gumbel`,
`categorical`) and for Dpsgd's noise (`normal`), so a seeded stream of
the port can be held to the reference's token by token. It follows JAX's
default `jax_threefry_partitionable = True` (jax/_src/prng.py): `split`
is the fold-like variant and a draw of shape S hashes the flat index of
every element, split into hi/lo 32-bit words (`iota_2x32_shape`), with
the two output words xor-ed together.

A key is a `[..., 2]` int64 tensor holding two uint32 words. The words
live in int64 because torch has no uint32 addition on the CPU; sums are
taken modulo 2^32 by masks and every right shift acts on non-negative
values, so it is a logical shift and the integer work is exact on the
CPU and on CUDA alike. The inexact steps are gumbel's `-log(-log(u))`,
whose `log` may differ from XLA's by an ulp, and normal's inverse error
function, which runs XLA's own polynomial (`_erf_inv`) but whose `log1p`
is torch's: it may land up to 2 ulps from XLA's.
Everything runs on the device of the key it is given.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000          # 1.0f: exponent 0, zero mantissa
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None) -> torch.Tensor:
    """x (an int, a sequence or a tensor) as uint32 words in int64."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words (x1, x2) under key words
    (k1, k2): 20 rounds, a key injection every 4, uint32 words in int64
    tensors that broadcast together. Returns the two output words.

    Only x1 is masked each round, since it is rotated: x0 only ever takes
    additions (at most 2^32 + 5 each, 26 of them, so it stays far below
    2^63) and its low 32 bits are right modulo 2^32; it is masked where
    it is xor-ed into x1 and at the end."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x1 + ks[0]
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & _MASK
    return x0 & _MASK, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: JAX's `threefry_seed`, the key
    [seed >> 32, seed & 0xFFFFFFFF]. A negative seed is taken as the
    int32 JAX makes of it (high word 0)."""
    seed = int(seed)
    hi = (seed >> 32) & _MASK if seed >= 0 else 0
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def _words(key):
    key = _u32(key)
    return key[..., 0], key[..., 1]


def fold_in(key, data) -> torch.Tensor:
    """`jax.random.fold_in`: the hash of the counter [0, uint32(data)]
    under `key`. `key [..., 2]` and `data` broadcast; vectorised over
    both (JAX's `vmap(fold_in)`)."""
    k1, k2 = _words(key)
    data = _u32(data, k1.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    y1, y2 = torch.broadcast_tensors(y1, y2)
    return torch.stack([y1, y2], dim=-1)


def _iota_2x32(shape, device):
    """(hi, lo) words of the flat index of every element of `shape`."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash_iota(key, shape):
    """Both hash words over the flat indices of `shape`, one draw per key
    of `key [..., 2]`: shape key.shape[:-1] + shape."""
    k1, k2 = _words(key)
    lead = k1.shape
    hi, lo = _iota_2x32(tuple(shape), k1.device)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(k1[expand], k2[expand], hi, lo), lead


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (fold-like): key i is the hash of the counter
    [0, i]. `key [..., 2]` -> `[..., num, 2]`."""
    (b1, b2), _ = _hash_iota(key, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` for 32 bits: the xor of the two hash
    words over the flat element indices. A batch of keys `[..., 2]` draws
    one `shape` each (JAX's `vmap` over keys)."""
    (b1, b2), _ = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval), then
    max(minval, ·). XLA fuses the scale and shift into one fused
    multiply-add; here the product is exact in fp64 and the sum is
    rounded once more to fp32, which gives the same bits."""
    bits = random_bits(key, shape)
    floats = (((bits >> 9) | _ONE_BITS).to(torch.int32)
              .view(torch.float32) - 1.0)
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo          # rounded to fp32, as XLA does
    scaled = (floats.double() * float(scale) + float(lo)).float()
    return scaled.clamp_min(float(lo))


# XLA's ErfInv32 (Giles' single-precision approximation): the Horner
# coefficients for w < 5 and for w >= 5, highest power first
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's `erf_inv` of fp32 `x` in its op order: w = -log1p(-x·x),
    a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x;
    ±1 maps to ±inf. XLA contracts each Horner step into a fused
    multiply-add: here the product is exact in fp64 and the sum is
    rounded once to fp32. (`torch.erfinv` is another approximation, up
    to 64 ulps away.)"""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coeff(i):
        return torch.where(lt, float(np.float32(_ERF_INV_LT5[i])),
                           float(np.float32(_ERF_INV_GE5[i]))).double()

    p = coeff(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = (coeff(i) + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key, shape) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) · erf_inv(u) with u
    uniform in [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return float(np.float32(math.sqrt(2.0))) * _erf_inv(u)


def gumbel(key, shape) -> torch.Tensor:
    """`jax.random.gumbel` in float32, mode "low":
    -log(-log(uniform(tiny, 1)))."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key, logits) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)` on fp32 logits: the
    argmax of gumbel noise + logits, the first index on ties. A single
    key `[2]` draws the noise over the whole of `logits`; a key per row
    `[B, 2]` with logits `[B, V]` draws each row on its own key (JAX's
    `vmap(categorical)`)."""
    key = _u32(key)
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
