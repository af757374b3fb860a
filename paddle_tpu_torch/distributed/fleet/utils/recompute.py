"""Activation recomputation (counterpart of
paddle_tpu/distributed/fleet/utils/recompute.py).

The forward of `function` keeps only its inputs; the backward runs it
again to rebuild what its gradient needs. The JAX package does this with
`jax.checkpoint`; here it is `torch.utils.checkpoint.checkpoint`, which is
autograd plumbing: every kernel the function launches (flash attention,
LayerNorm) runs again in the backward.

JAX's remat is traced, so the autocast state and the random draws of the
first run are baked into what it recomputes. A torch checkpoint runs the
function again in the backward, outside the `auto_cast` block that ran the
first forward and after later draws. So `recompute` captures, at the
first run, the port's autocast state (`core/amp.py`) and its random state
(`core/random.py`: the seed counter and the dropout generators, beside
PyTorch's default generators that `preserve_rng_state` covers) and runs
the recomputation under both, then puts back what was there: the
recomputed forward casts and draws exactly as the first one did.

A traced JAX forward has no side effects to repeat: a BatchNorm's running
statistics leave a `jax.checkpoint` as outputs of the first run, once. A
torch checkpoint reruns the eager forward, which would move them again, so
the rerun sets `replaying()` and `nn.functional.batch_norm` normalises
with the batch's statistics without updating the running ones there.
"""
from __future__ import annotations

import contextlib
import functools
import threading

from torch.utils.checkpoint import checkpoint

from ....core.amp import amp_restored, amp_snapshot
from ....core.random import rng_restore, rng_snapshot


class _ReplayState(threading.local):
    def __init__(self):
        self.depth = 0


_REPLAY = _ReplayState()


def replaying() -> bool:
    """True while this thread reruns a recomputed forward."""
    return _REPLAY.depth > 0


@contextlib.contextmanager
def _replay():
    _REPLAY.depth += 1
    try:
        yield
    finally:
        _REPLAY.depth -= 1


def _replaying(function, preserve_rng_state):
    """`function` wrapped to run under the autocast state of this call and,
    from its second run on, the random state of its first and with
    `replaying()` set."""
    amp = amp_snapshot()
    rng = rng_snapshot() if preserve_rng_state else None
    runs = []

    def run(*args):
        if not runs:
            runs.append(True)
            with amp_restored(amp):
                return function(*args)
        if rng is None:
            with amp_restored(amp), _replay():
                return function(*args)
        after = rng_snapshot()
        rng_restore(rng)
        try:
            with amp_restored(amp), _replay():
                return function(*args)
        finally:
            rng_restore(after)

    return run


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """function(*args, **kwargs), its activations recomputed in the
    backward under the autocast and random state of this call. With
    `use_reentrant` (the default, as in Paddle) at least one tensor input
    must require grad for any gradient to flow; `use_reentrant=False`
    also differentiates what `function` reaches through its closure (the
    strategy step's whole-loss and selective recompute)."""
    if kwargs:
        function = functools.partial(function, **kwargs)
    return checkpoint(_replaying(function, preserve_rng_state), *args,
                      use_reentrant=use_reentrant,
                      preserve_rng_state=preserve_rng_state)
