from . import functional  # noqa: F401
from .layer import (Dropout, Embedding, Layer, LayerList,  # noqa: F401
                    LayerNorm, Linear, MoELayer)
