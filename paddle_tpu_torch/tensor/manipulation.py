"""flatten (counterpart of paddle_tpu/tensor/manipulation.py:30)."""
from __future__ import annotations


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """x with the axes start_axis..stop_axis (negative counts from the
    end) merged into one."""
    nd = x.ndim
    s0, s1 = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:s0]) + (-1,) + tuple(x.shape[s1 + 1:]))
