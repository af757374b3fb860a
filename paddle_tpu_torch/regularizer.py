"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py).

Passed as an optimizer's `weight_decay=`: L2Decay contributes
`coeff * p` through the update rule's weight-decay term; L1Decay
contributes `coeff * sign(p)`, folded into the gradient before the rule
(`Optimizer._reg_grad`), as the JAX package's compiled path does.
"""
from __future__ import annotations


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L2Decay(WeightDecayRegularizer):
    """loss += coeff/2 * ||p||^2  =>  grad += coeff * p."""


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * ||p||_1  =>  grad += coeff * sign(p)."""


__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]
