"""The VGG family (counterpart of paddle_tpu/vision/models/vgg.py): the
JAX configurations A, B, D and E, with or without BatchNorm, and the JAX
layer names (`features.0.weight`, `classifier.6.bias`).

`device`, `dtype` and `generator` as `lenet.py` takes them; `pretrained`
is ignored, as in JAX: nothing is fetched.
"""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Layer,
                   Linear, MaxPool2D, ReLU, Sequential)
from ...tensor.manipulation import flatten
from ._build import draw_weights, layer_kw

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_features(cfg, batch_norm=False, device=None, dtype=None):
    """The convolutional trunk of a configuration: 3x3 convolutions
    (each followed by a BatchNorm2D with `batch_norm`) and ReLUs, a 2x2
    max pool at each "M"."""
    kw = layer_kw(device, dtype)
    layers = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(Conv2D(in_ch, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(BatchNorm2D(v, **kw))
            layers.append(ReLU())
            in_ch = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, num_classes, **kw))
        draw_weights(self, kw["device"], generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm, pretrained=False, device=None, dtype=None,
         **kwargs):
    return VGG(make_features(_CFGS[cfg], batch_norm, device, dtype),
               device=device, dtype=dtype, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
