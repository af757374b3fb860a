from .common import Dropout, Embedding, Linear  # noqa: F401
from .layers import Layer, LayerList  # noqa: F401
from .moe import MoELayer  # noqa: F401
from .norm import LayerNorm  # noqa: F401
