"""Global RNG state (counterpart of paddle_tpu/core/random.py).

The JAX package keeps one (seed, counter) pair on the host and folds the
counter into a PRNG key for every draw. The port keeps the same pair and
hands out plain integers instead: `next_seed()` mixes (seed, counter)
with SplitMix64 on the host, so a fresh seed costs no device sync. Two
consumers take them:

- the attention kernels' dropout, keyed by one such seed (Philox, see
  `ops.attention.dropout_keep_mask`);
- `nn.functional.dropout`, which draws from a `torch.Generator` per
  device, seeded from this state when first used and again after every
  `seed(s)`.

The named tracker states of tensor parallelism come with the multi-GPU
modules.
"""
from __future__ import annotations

import threading

import torch

_MASK64 = (1 << 64) - 1


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.counter = 0
        self.generators = {}   # torch.device -> torch.Generator


_RNG = _RngState()


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def seed(s: int):
    """Reset the state to seed `s`: the seeds and generators that follow
    repeat from here."""
    _RNG.seed = int(s)
    _RNG.counter = 0
    _RNG.generators = {}
    return s


def next_seed() -> int:
    """A fresh seed in [0, 2**63) from (seed, counter); advances the
    counter. Host arithmetic only."""
    c = _RNG.counter
    _RNG.counter += 1
    return _splitmix64(_splitmix64(_RNG.seed & _MASK64) ^ c) >> 1


def generator(device) -> torch.Generator:
    """The generator of `device` for host-drawn random tensors (dropout),
    seeded from `next_seed()` on first use after `seed()`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _RNG.generators.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(next_seed())
        _RNG.generators[dev] = gen
    return gen


def rng_snapshot():
    """This thread's state: (seed, counter, {device: generator state})."""
    return (_RNG.seed, _RNG.counter,
            {d: g.get_state() for d, g in _RNG.generators.items()})


def rng_restore(snapshot):
    """Set the state to `snapshot` (from rng_snapshot()): the seeds and
    draws that follow repeat those that followed the snapshot. A
    generator made after the snapshot is dropped, so its next use seeds
    a new one from the restored counter, as it did then."""
    _RNG.seed, _RNG.counter, states = snapshot
    gens = {}
    for d, st in states.items():
        gen = _RNG.generators.get(d)
        if gen is None:
            gen = torch.Generator(device=d)
        gen.set_state(st)
        gens[d] = gen
    _RNG.generators = gens
