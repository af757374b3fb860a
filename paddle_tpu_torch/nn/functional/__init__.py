from .activation import (hardsigmoid, hardswish, log_sigmoid,  # noqa: F401
                         log_softmax, mish, relu, relu6, sigmoid, silu,
                         softmax, softsign, swish, tanh, tanhshrink)
from .common import dropout, dropout2d, dropout3d, linear  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
