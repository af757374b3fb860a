"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py).

Passed as an optimizer's `weight_decay=`: L2Decay contributes
`coeff * p` through the update rule's weight-decay term. L1Decay waits
for the optimizer slice (ROADMAP §1).
"""
from __future__ import annotations


class L2Decay:
    """loss += coeff/2 * ||p||^2  =>  grad += coeff * p."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
