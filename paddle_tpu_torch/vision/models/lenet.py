"""LeNet (counterpart of paddle_tpu/vision/models/lenet.py): the JAX
model's layers and names (`features.0.weight` ... `fc.3.bias`).

`device` defaults to CUDA (raises without a GPU; pass device="cpu" for
the CPU), `dtype` to float32; the weights are drawn from `generator` (a
torch.Generator on `device`, seeded 0 when None) in module order.
"""
from __future__ import annotations

from ...nn import (Conv2D, Flatten, Layer, Linear, MaxPool2D, ReLU,
                   Sequential)
from ._build import draw_weights, layer_kw


class LeNet(Layer):
    def __init__(self, num_classes=10, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Flatten(), Linear(400, 120, **kw), Linear(120, 84, **kw),
                Linear(84, num_classes, **kw))
        draw_weights(self, kw["device"], generator)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
