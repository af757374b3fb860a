from .activation import log_softmax, softmax  # noqa: F401
from .common import dropout, dropout2d, dropout3d, linear  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
