from . import lr  # noqa: F401
from .optimizer import (SGD, Adam, AdamW, Lamb, LarsMomentum,  # noqa: F401
                        Momentum, Optimizer)
