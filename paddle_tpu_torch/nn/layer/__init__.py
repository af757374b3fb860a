from .activation import (Hardsigmoid, Hardswish, LogSigmoid, Mish,  # noqa: F401,E501
                         ReLU, ReLU6, Sigmoid, Silu, Softsign, Swish, Tanh,
                         Tanhshrink)
from .common import Dropout, Embedding, Flatten, Linear  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layers import Layer, LayerList, Sequential  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .moe import MoELayer  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, LayerNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
