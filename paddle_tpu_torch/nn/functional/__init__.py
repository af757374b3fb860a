from .common import dropout, dropout2d, dropout3d  # noqa: F401
from .norm import layer_norm  # noqa: F401
