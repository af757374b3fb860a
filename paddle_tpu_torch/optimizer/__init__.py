from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, DecayedAdagrad, Dpsgd, Ftrl, Lamb,
                        LarsMomentum, Momentum, Optimizer, ProximalAdagrad,
                        ProximalGD, RMSProp)
