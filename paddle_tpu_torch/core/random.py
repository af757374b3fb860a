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

Named streams (`get_rng_state_tracker()`, the JAX `RNGStatesTracker`):
each has its own (seed, counter) pair and its own generators, and inside
`tracker.rng_state(name)` both consumers draw from that stream instead of
the global one. `model_parallel_random_seed(seed, mp_rank, dp_rank)` adds
"global_seed" (the same on every mp rank of a data-parallel replica) and
"local_seed" (distinct for each mp rank) with the JAX offsets
(core/random.py:102-115), and reseeds the global stream, as `fleet.init`
does.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_MASK64 = (1 << 64) - 1


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.counter = 0
        self.generators = {}   # (stream, torch.device) -> torch.Generator
        self.tracker_states = {}  # name -> [seed, counter]
        self.active = None        # the tracker stream in use, or None


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
    _RNG.generators = {k: g for k, g in _RNG.generators.items()
                       if k[0] is not None}
    return s


def next_seed() -> int:
    """A fresh seed in [0, 2**63) from the active stream's (seed,
    counter) (the global one outside a tracker's `rng_state`); advances
    its counter. Host arithmetic only."""
    if _RNG.active is not None:
        st = _RNG.tracker_states[_RNG.active]
        s, c = st
        st[1] += 1
    else:
        s, c = _RNG.seed, _RNG.counter
        _RNG.counter += 1
    return _splitmix64(_splitmix64(s & _MASK64) ^ c) >> 1


def generator(device) -> torch.Generator:
    """The active stream's generator of `device` for host-drawn random
    tensors (dropout), seeded from `next_seed()` on first use after
    `seed()` (or after the stream was added)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (_RNG.active, dev)
    gen = _RNG.generators.get(key)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(next_seed())
        _RNG.generators[key] = gen
    return gen


def rng_snapshot():
    """This thread's state: (seed, counter, {(stream, device): generator
    state}, {name: (seed, counter)})."""
    return (_RNG.seed, _RNG.counter,
            {k: g.get_state() for k, g in _RNG.generators.items()},
            {k: tuple(v) for k, v in _RNG.tracker_states.items()})


def rng_restore(snapshot):
    """Set the state to `snapshot` (from rng_snapshot()): the seeds and
    draws that follow repeat those that followed the snapshot. A
    generator made after the snapshot is dropped, so its next use seeds
    a new one from the restored counter, as it did then."""
    _RNG.seed, _RNG.counter, states, tracker = snapshot
    gens = {}
    for k, st in states.items():
        gen = _RNG.generators.get(k)
        if gen is None:
            gen = torch.Generator(device=k[1])
        gen.set_state(st)
        gens[k] = gen
    _RNG.generators = gens
    _RNG.tracker_states = {k: list(v) for k, v in tracker.items()}


class RNGStatesTracker:
    """Named RNG streams (the JAX `RNGStatesTracker`): `add(name, seed)`,
    then `with tracker.rng_state(name):` draws from that stream."""

    def add(self, name: str, seed_: int):
        if name in _RNG.tracker_states:
            raise ValueError(f"RNG state {name!r} already exists")
        _RNG.tracker_states[name] = [int(seed_), 0]

    def states(self):
        return {k: tuple(v) for k, v in _RNG.tracker_states.items()}

    def reset(self):
        """Drop every named stream and its generators."""
        _RNG.tracker_states = {}
        _RNG.generators = {k: g for k, g in _RNG.generators.items()
                           if k[0] is None}

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name not in _RNG.tracker_states:
            raise ValueError(f"RNG state {name!r} not added")
        prev = _RNG.active
        _RNG.active = name
        try:
            yield
        finally:
            _RNG.active = prev


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(base_seed: int, mp_rank: int,
                               dp_rank: int = 0):
    """The streams of tensor parallelism (the JAX function, fleet_base's
    offsets): "global_seed" = base + 1000 dp_rank, shared by the mp ranks
    of a replica; "local_seed" = base + 1024 + 100 mp_rank + 1000
    dp_rank, distinct for each; the global stream is reseeded with the
    global seed."""
    global_seed = base_seed + dp_rank * 1000
    local_seed = base_seed + 1024 + mp_rank * 100 + dp_rank * 1000
    for name in ("global_seed", "local_seed"):
        _RNG.tracker_states.pop(name, None)
        _RNG.generators = {k: g for k, g in _RNG.generators.items()
                           if k[0] != name}
    _TRACKER.add("global_seed", global_seed)
    _TRACKER.add("local_seed", local_seed)
    seed(global_seed)
