from . import functional  # noqa: F401
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveAvgPool3D, AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                    AdaptiveMaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, Conv1D,
                    Conv2D, Conv3D, CrossEntropyLoss, Dropout, Embedding,
                    Flatten, Hardsigmoid, Hardswish, Layer, LayerList,
                    LayerNorm, Linear, LogSigmoid, MaxPool1D, MaxPool2D,
                    MaxPool3D, Mish, MoELayer, ReLU, ReLU6, Sequential,
                    Sigmoid, Silu, Softsign, Swish, SyncBatchNorm, Tanh,
                    Tanhshrink)
