"""Activation recomputation (counterpart of
paddle_tpu/distributed/fleet/utils/recompute.py).

The forward of `function` keeps only its inputs; the backward runs it
again to rebuild what its gradient needs, with the RNG state of the first
run restored. The JAX package does this with `jax.checkpoint`; here it is
`torch.utils.checkpoint.checkpoint`, which is autograd plumbing: every
kernel the function launches (flash attention, LayerNorm) runs again in
the backward.
"""
from __future__ import annotations

import functools

from torch.utils.checkpoint import checkpoint


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """function(*args, **kwargs), its activations recomputed in the
    backward. With `use_reentrant` (the default, as in Paddle) at least
    one tensor input must require grad for any gradient to flow."""
    if kwargs:
        # the reentrant checkpoint takes positional arguments only
        function = functools.partial(function, **kwargs)
    return checkpoint(function, *args, use_reentrant=use_reentrant,
                      preserve_rng_state=preserve_rng_state)
