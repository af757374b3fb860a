from .common import dropout, dropout2d, dropout3d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
